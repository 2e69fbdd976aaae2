"""DeepSeekMoE 16B: fine-grained experts, 2 shared + 64 routed top-6.
[arXiv:2401.06066; hf]"""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
    d_ff=1408, vocab_size=102400, activation="swiglu",
    moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408, n_shared=2),
)

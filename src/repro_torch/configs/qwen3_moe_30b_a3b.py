"""Qwen3-30B-A3B MoE: 128 experts top-8, qk-norm GQA.
[hf:Qwen/Qwen3-30B-A3B; hf]"""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, d_head=128,
    d_ff=768, vocab_size=151936, activation="swiglu", qk_norm=True,
    moe=MoEConfig(n_experts=128, top_k=8, d_expert=768, n_shared=0),
)

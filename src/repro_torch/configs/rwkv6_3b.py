"""RWKV6 (Finch) 3B: attention-free, data-dependent decay linear attention.
[arXiv:2404.05892; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40, d_head=64,
    d_ff=8960, vocab_size=65536, activation="relu2", rwkv_head_dim=64,
)

"""Qwen3 0.6B: dense GQA decoder with qk-norm.
[hf:Qwen/Qwen3-8B; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-0.6b", family="dense",
    n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8, d_head=128,
    d_ff=3072, vocab_size=151936, activation="swiglu", qk_norm=True,
)

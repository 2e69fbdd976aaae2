"""Phi-4-mini 3.8B: dense GQA decoder, RoPE + SwiGLU.
[arXiv:2412.08905; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="phi4-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, d_head=128,
    d_ff=8192, vocab_size=200064, activation="swiglu",
)

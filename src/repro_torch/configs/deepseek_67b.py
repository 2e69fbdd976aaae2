"""DeepSeek 67B: llama-architecture dense GQA decoder.
[arXiv:2401.02954; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-67b", family="dense",
    n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=22016, vocab_size=102400, activation="swiglu",
)

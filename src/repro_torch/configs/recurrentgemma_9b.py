"""RecurrentGemma 9B (Griffin): RG-LRU + local attention, 1 attn : 2 rec.
[arXiv:2402.19427; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, d_head=256,
    d_ff=12288, vocab_size=256000, activation="geglu",
    block_pattern=("rec", "rec", "attn"), local_window=2048, d_rnn=4096,
)

"""Whisper-small: encoder-decoder; conv audio frontend STUBBED —
input_specs provide precomputed frame embeddings (B, 1500, d).
[arXiv:2212.04356; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small", family="encdec",
    n_layers=12, n_encoder_layers=12, d_model=768, n_heads=12,
    n_kv_heads=12, d_head=64, d_ff=3072, vocab_size=51865,
    activation="gelu", n_frames=1500,
)

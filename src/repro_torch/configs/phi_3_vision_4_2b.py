"""Phi-3-vision 4.2B: phi3-mini backbone + CLIP patch frontend (a stub: the
batch carries precomputed patch embeddings, ``batch["patches"]``).
[hf:microsoft/Phi-3-vision-128k-instruct; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b", family="vlm",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, d_head=96,
    d_ff=8192, vocab_size=32064, activation="swiglu", n_patches=256,
)

"""Nemotron-4 15B: dense GQA decoder with squared-ReLU MLP.
[arXiv:2402.16819; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-15b", family="dense",
    n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8, d_head=128,
    d_ff=24576, vocab_size=256000, activation="relu2",
)

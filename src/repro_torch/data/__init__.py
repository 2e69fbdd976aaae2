"""Deterministic synthetic datasets (own copy of the reference's numpy
generators, so both packages see byte-identical arrays)."""
from .synthetic import make_jsc, make_mnist_like

__all__ = ["make_jsc", "make_mnist_like"]

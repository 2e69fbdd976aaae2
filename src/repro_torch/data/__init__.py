"""Deterministic data pipelines (own copies of the reference's numpy
generators, so both packages see byte-identical arrays)."""
from .synthetic import make_jsc, make_mnist_like
from .tokens import TokenStream, lm_batch_specs

__all__ = ["make_jsc", "make_mnist_like", "TokenStream", "lm_batch_specs"]

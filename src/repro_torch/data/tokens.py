"""Deterministic LM token pipeline with sharded, restartable iteration.

Own copy of the reference's ``data/tokens.py`` (numpy only): for the same
``(seed, step, shard)`` :meth:`TokenStream.batch_at` yields the reference's
tokens bit for bit.  Tokens are generated from ``(seed, step, shard)`` so
that every host produces exactly its own shard with no coordination, and
a restart from a checkpoint resumes the stream exactly (skip-ahead is
O(1): the generator is counter-based, not stateful).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TokenStream:
    """Counter-based deterministic token source (fold-in of step and
    shard)."""

    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    shard_index: int = 0
    shard_count: int = 1

    @property
    def local_batch(self) -> int:
        if self.global_batch % self.shard_count:
            raise ValueError("global_batch must divide by shard_count")
        return self.global_batch // self.shard_count

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """Batch for ``step``; a pure function of (seed, step, shard)."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.shard_index]))
        # a Zipf-like marginal over the vocabulary, as natural text has
        z = rng.zipf(1.3, size=(self.local_batch, self.seq_len + 1))
        tokens = (z - 1) % self.vocab_size
        return {
            "tokens": tokens[:, :-1].astype(np.int32),
            "labels": tokens[:, 1:].astype(np.int32),
        }


def lm_batch_specs(global_batch: int, seq_len: int,
                   extra: dict | None = None) -> dict[str, tuple]:
    """Shape-only stand-ins for a training batch: ``{name: (shape, numpy
    dtype)}`` (the reference returns ``jax.ShapeDtypeStruct``\\ s)."""
    specs = {
        "tokens": ((global_batch, seq_len), np.dtype(np.int32)),
        "labels": ((global_batch, seq_len), np.dtype(np.int32)),
    }
    if extra:
        specs.update(extra)
    return specs

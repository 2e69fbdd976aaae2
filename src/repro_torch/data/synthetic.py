"""Structure-matched synthetic stand-ins for the paper's datasets.

Own copy of the reference's ``data/synthetic.py`` (numpy only): for the
same arguments the arrays are byte-identical to the reference's.

The JSC OpenML dump and MNIST are not bundled offline, so
benchmarks use generators that match the *shape and difficulty profile*
needed to exercise the claims: learnable class structure, realistic feature
correlations, and (crucially for ReducedLUT) input distributions that leave
a large fraction of each L-LUT's input space unobserved.
"""
from __future__ import annotations

import numpy as np


def make_jsc(
    n_train: int = 20000,
    n_test: int = 5000,
    n_features: int = 16,
    n_classes: int = 5,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Jet-substructure-like tabular data: 16 correlated physics-ish
    features, 5 classes, Gaussian mixtures with shared covariance.

    Returns ``(x_train, y_train, x_test, y_test)`` with features in [0, 1].
    """
    rng = np.random.default_rng(seed)
    n = n_train + n_test
    # class means on a low-dimensional manifold + shared correlated noise
    basis = rng.normal(size=(4, n_features))
    means = rng.normal(size=(n_classes, 4)) @ basis * 1.4
    chol = np.linalg.cholesky(
        0.5 * np.eye(n_features)
        + 0.5 * basis.T @ basis / 4
        + 1e-3 * np.eye(n_features)
    )
    y = rng.integers(0, n_classes, size=n)
    x = means[y] + rng.normal(size=(n, n_features)) @ chol.T
    # squash to [0, 1] like the preprocessed JSC features
    x = 1.0 / (1.0 + np.exp(-x / 2.0))
    return (
        x[:n_train].astype(np.float32), y[:n_train].astype(np.int32),
        x[n_train:].astype(np.float32), y[n_train:].astype(np.int32),
    )


def make_mnist_like(
    n_train: int = 12000,
    n_test: int = 2500,
    side: int = 28,
    n_classes: int = 10,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Sparse strokes-like images: each class is a fixed set of line
    segments with jitter, giving MNIST-like sparsity (~19% ink) and
    learnable structure.
    """
    rng = np.random.default_rng(seed)
    n = n_train + n_test
    protos = []
    for c in range(n_classes):
        crng = np.random.default_rng(1000 + c)
        segs = crng.integers(0, side, size=(5, 4))
        protos.append(segs)
    y = rng.integers(0, n_classes, size=n)
    x = np.zeros((n, side, side), dtype=np.float32)
    for i in range(n):
        segs = protos[y[i]]
        jitter = rng.integers(-2, 3, size=segs.shape)
        for (r0, c0, r1, c1) in np.clip(segs + jitter, 0, side - 1):
            steps = max(abs(int(r1) - int(r0)), abs(int(c1) - int(c0)), 1)
            rr = np.linspace(r0, r1, steps + 1).round().astype(int)
            cc = np.linspace(c0, c1, steps + 1).round().astype(int)
            x[i, rr, cc] = 1.0
        x[i] += rng.normal(0, 0.08, size=(side, side)).astype(np.float32)
    x = np.clip(x, 0.0, 1.0).reshape(n, side * side)
    return (
        x[:n_train], y[:n_train].astype(np.int32),
        x[n_train:], y[n_train:].astype(np.int32),
    )

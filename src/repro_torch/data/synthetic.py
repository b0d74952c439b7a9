"""Synthetic datasets (the port of ``repro/data/synthetic.py``:
``make_classification_dataset`` only). The body is a numpy copy of the
reference's, so it draws the same bits from the same seed."""
from __future__ import annotations

import numpy as np


def make_classification_dataset(n: int, shape=(28, 28, 1), n_classes: int = 10,
                                seed: int = 0, noise: float = 1.2):
    """Gaussian class prototypes + noise. Returns (x (n,*shape), y (n,))."""
    rng = np.random.RandomState(seed)
    protos = rng.randn(n_classes, *shape).astype(np.float32)
    y = rng.randint(0, n_classes, size=n)
    x = protos[y] + noise * rng.randn(n, *shape).astype(np.float32)
    # normalize like the paper (Alg 1 line 1): zero mean, unit variance
    x = (x - x.mean()) / (x.std() + 1e-8)
    return x.astype(np.float32), y.astype(np.int32)

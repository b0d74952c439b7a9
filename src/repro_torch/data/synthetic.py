"""Synthetic datasets (the port of ``repro/data/synthetic.py``:
``make_classification_dataset`` and ``SyntheticLMStream``). The bodies are
numpy copies of the reference's, so they draw the same bits from the same
seed."""
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


class SyntheticLMStream:
    """Deterministic, seekable LM token stream.

    Tokens follow t_{i+1} = (a·t_i + b + structured noise) mod V with a
    per-position pattern — next-token prediction is learnable well below
    uniform entropy. ``batch_at(step)`` is a pure function of (seed, step,
    shard), which is what makes checkpoint-resume exact and data sharding
    across pods/hosts deterministic (DESIGN.md §8).
    """

    def __init__(self, vocab_size: int, seq: int, batch: int, seed: int = 0,
                 shard: int = 0, n_shards: int = 1):
        self.V = vocab_size
        self.seq = seq
        self.batch = batch
        self.seed = seed
        self.shard = shard
        self.n_shards = n_shards

    def batch_at(self, step: int):
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + step * self.n_shards + self.shard)
            % (2**31 - 1))
        B, S, V = self.batch, self.seq, self.V
        a = 31 % V or 1
        t0 = rng.randint(0, V, size=(B, 1))
        noise = (rng.rand(B, S) < 0.15) * rng.randint(0, V, size=(B, S))
        toks = [t0]
        for i in range(1, S):
            nxt = (a * toks[-1] + 7 + (i % 5)) % V
            toks.append(np.where(noise[:, i:i + 1] > 0,
                                 noise[:, i:i + 1] % V, nxt))
        tokens = np.concatenate(toks, axis=1).astype(np.int32)
        targets = np.concatenate(
            [tokens[:, 1:], tokens[:, :1]], axis=1).astype(np.int32)
        mask = np.ones((B, S), np.float32)
        mask[:, -1] = 0.0
        return {"tokens": tokens, "targets": targets, "mask": mask}

"""Training problems for the PS runtime (the port of ``repro/ps/problems.py``:
``ProblemSpec``, ``spec``, the numpy MLPs and the autograd MLP behind the
zoo name ``jax-mlp``).

Contract, on the run's device:

    grad_fn(w_row, step, worker) -> grad_row      # f64 tensors
    eval_fn(w_row) -> float                       # e.g. test error

A problem is described by a ``ProblemSpec`` (dotted factory path + kwargs)
and built with ``build(device)``. Worker-private minibatch streams are
``np.random.RandomState(1000 + worker)``, one draw per call, as in the
reference — so the same spec feeds the port and the reference identical
minibatches whenever the per-worker call orders match.
"""
from __future__ import annotations

import dataclasses
import importlib
import math

import numpy as np
import torch

from repro_torch.data.synthetic import make_classification_dataset
from repro_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ProblemSpec:
    """factory = "module:function"; ``build(device)`` imports the module and
    calls ``function(device=device, **kwargs)`` -> (w0, grad_fn, eval_fn)."""

    factory: str
    kwargs: tuple = ()        # tuple of (key, value) pairs — hashable

    def build(self, device=None):
        mod_name, fn_name = self.factory.split(":")
        fn = getattr(importlib.import_module(mod_name), fn_name)
        return fn(device=device, **dict(self.kwargs))


def spec(factory: str, **kwargs) -> ProblemSpec:
    return ProblemSpec(factory=factory, kwargs=tuple(sorted(kwargs.items())))


def _mlp_shapes(d_in, d_hidden, n_classes):
    return ((d_in, d_hidden), (d_hidden,), (d_hidden, n_classes),
            (n_classes,))


def _unpack(w, shapes):
    out, off = [], 0
    for s in shapes:
        size = int(np.prod(s))
        out.append(w[off:off + size].reshape(s))
        off += size
    return out


def make_numpy_mlp(seed: int = 0, n_train: int = 2048, n_test: int = 512,
                   d_in: int = 32, d_hidden: int = 32, n_classes: int = 4,
                   batch: int = 16, noise: float = 1.6, device=None):
    """One-hidden-layer tanh MLP on the Gaussian-mixture task, gradients by
    hand in numpy on the host — the reference's code, unchanged, so it is
    the bitwise pin of the whole runtime. Rows come in and go out as f64
    tensors on ``device``: ``grad_fn`` reads its row back to the host and
    moves the gradient to the device."""
    dev = resolve_device(device)
    x, y = make_classification_dataset(n_train + n_test, shape=(d_in,),
                                       n_classes=n_classes, noise=noise,
                                       seed=seed)
    x = x.astype(np.float64)
    xtr, ytr = x[:n_train], y[:n_train]
    xte, yte = x[n_train:], y[n_train:]
    shapes = _mlp_shapes(d_in, d_hidden, n_classes)
    rng = np.random.RandomState(seed + 1)
    w0 = np.concatenate([
        (rng.randn(*s) / np.sqrt(max(s[0], 1) if len(s) > 1 else 1)
         ).reshape(-1)
        for s in shapes]).astype(np.float64)

    def forward(w, xb):
        w1, b1, w2, b2 = _unpack(w, shapes)
        h = np.tanh(xb @ w1 + b1)
        return h, h @ w2 + b2

    rngs = {}

    def grad_fn(w_row, step, worker):
        w = w_row.cpu().numpy()
        r = rngs.setdefault(worker, np.random.RandomState(1000 + worker))
        idx = r.randint(0, n_train, size=batch)
        xb, yb = xtr[idx], ytr[idx]
        w1, b1, w2, b2 = _unpack(w, shapes)
        h, logits = forward(w, xb)
        logits -= logits.max(axis=1, keepdims=True)
        p = np.exp(logits)
        p /= p.sum(axis=1, keepdims=True)
        p[np.arange(batch), yb] -= 1.0
        p /= batch                              # d loss / d logits
        dw2 = h.T @ p
        db2 = p.sum(axis=0)
        dh = (p @ w2.T) * (1.0 - h * h)
        dw1 = xb.T @ dh
        db1 = dh.sum(axis=0)
        g = np.concatenate([dw1.reshape(-1), db1, dw2.reshape(-1), db2])
        return torch.from_numpy(g).to(dev)

    def eval_fn(w_row):
        _, logits = forward(w_row.cpu().numpy(), xte)
        return float(np.mean(logits.argmax(axis=1) != yte))

    grad_fn.layer_sizes = [int(np.prod(s)) for s in shapes]
    return torch.from_numpy(w0).to(dev), grad_fn, eval_fn


NUMPY_MLP = spec("repro_torch.ps.problems:make_numpy_mlp")

# the reference's BENCH_ps_runtime problem (~9k params, ~70 KB packed)
NUMPY_MLP_MED = spec("repro_torch.ps.problems:make_numpy_mlp",
                     d_in=64, d_hidden=128, batch=32, n_train=4096,
                     n_test=1024, n_classes=4)

# a bandwidth-heavy variant (~68k params, ~0.5 MB packed): the exchange
# costs real memory bandwidth
NUMPY_MLP_LARGE = spec("repro_torch.ps.problems:make_numpy_mlp",
                       d_in=128, d_hidden=512, batch=32, n_train=4096,
                       n_test=1024, n_classes=4)


def make_jax_mlp(seed: int = 0, n_train: int = 2048, n_test: int = 512,
                 d_in: int = 32, d_hidden: int = 64, n_classes: int = 4,
                 batch: int = 16, noise: float = 1.6, depth: int = 2,
                 w0=None, device=None):
    """The zoo's ``jax-mlp``: the reference's jax-backed MLP problem
    (``repro/ps/problems.py`` ``make_jax_mlp``, keeping its name so its
    counterpart is found), computed here by torch autograd — ``depth``
    ReLU layers (``models.cnn.mlp_apply``), f32 compute, f64 rows at the
    runtime boundary, worker ``w``'s batches from
    ``np.random.RandomState(1000 + w)``. Spawn-safe: a module-level
    factory that process and tcp workers rebuild from its spec.

    The flat row is ``ravel_pytree``'s (sorted keys: ``b0, b1, b_out, w0,
    w1, w_out``). ``w0`` is such a row (the reference's own init, carried
    across); without it the port draws He-normal weights from
    ``torch.Generator().manual_seed(seed)``."""
    from repro_torch.models import cnn
    from repro_torch.utils.device import fp32_products

    dev = resolve_device(device)
    fp32_products()
    x, y = make_classification_dataset(n_train + n_test, shape=(d_in,),
                                       n_classes=n_classes, noise=noise,
                                       seed=seed)
    x = torch.from_numpy(x).to(dev)
    y = torch.from_numpy(y.astype(np.int64)).to(dev)
    xtr, ytr, xte, yte = x[:n_train], y[:n_train], x[n_train:], y[n_train:]
    dims = {"d_in": d_in, "d_hidden": d_hidden, "depth": depth}
    if w0 is None:
        row = cnn.flatten_params(cnn.mlp_init(
            torch.Generator().manual_seed(seed), n_classes=n_classes,
            device=dev, **dims))
    else:
        row = torch.as_tensor(np.array(w0, dtype=np.float64)).to(dev)
    layout = cnn.ravel_layout("mlp", n_classes, **dims)
    if row.numel() != sum(math.prod(s) for _, s in layout):
        raise ValueError(f"w0 has {row.numel()} elements, not the mlp's")

    rngs: dict = {}

    def grad_fn(w, step, worker):
        rng = rngs.setdefault(worker, np.random.RandomState(1000 + worker))
        idx = torch.from_numpy(rng.randint(0, n_train, size=batch)).to(dev)
        leaf = w.detach().to(torch.float32).requires_grad_(True)
        params = cnn.unflatten(leaf, "mlp", n_classes, **dims)
        loss = cnn.xent_loss(cnn.mlp_apply(params, xtr[idx], depth),
                             ytr[idx])
        loss.backward()
        return leaf.grad.to(torch.float64)

    @torch.no_grad()
    def eval_fn(w):
        params = cnn.unflatten(w.to(torch.float32), "mlp", n_classes, **dims)
        return 1.0 - float(cnn.accuracy(cnn.mlp_apply(params, xte, depth),
                                        yte))

    grad_fn.layer_sizes = [math.prod(s) for _, s in layout]
    return row, grad_fn, eval_fn


JAX_MLP = spec("repro_torch.ps.problems:make_jax_mlp")

"""Real models as PS problems (the port of ``repro/ps/zoo.py``:
``make_zoo_lm``, ``make_zoo_cnn``, ``names`` and ``resolve``).

The gradient is computed on the run's device. The f64 row is cast to ONE
f32 leaf with ``requires_grad``; the parameters are views of that leaf in
``ravel_pytree`` order, so after forward and backward ``leaf.grad`` already
is the flat gradient in the reference's order. ``grad_fn.layer_sizes``
gives the per-leaf sizes in the same order, for the bucket cuts.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import configs
from repro_torch.data.synthetic import make_classification_dataset
from repro_torch.models import cnn
from repro_torch.models import transformer as tfm
from repro_torch.models.common import init_params
from repro_torch.ps.problems import (JAX_MLP, NUMPY_MLP, NUMPY_MLP_LARGE,
                                     NUMPY_MLP_MED, ProblemSpec, spec)
from repro_torch.utils.device import fp32_products, resolve_device

_CNNS = {"lenet": ((28, 28, 1), cnn.lenet_init, cnn.lenet_apply),
         "alexnet": ((32, 32, 3), cnn.alexnet_init, cnn.alexnet_apply)}


def _row_from(w0, dev) -> torch.Tensor:
    if isinstance(w0, torch.Tensor):
        return w0.detach().to(dev, torch.float64).clone()
    return torch.from_numpy(np.array(w0, dtype=np.float64)).to(dev)


def make_zoo_lm(arch: str = "gemma3-4b", seq: int = 24, batch: int = 2,
                seed: int = 0, w0=None, device=None):
    """The reduced-config decoder LM of ``arch`` as a PS problem:
    next-token loss on synthetic token streams, as the reference builds it
    (``repro/ps/zoo.py:48``; an M-RoPE arch gets the positions broadcast
    over its three streams): worker ``w`` draws its batches from
    ``np.random.RandomState(1000 + w)``, the eval batch comes from
    ``RandomState(seed + 7)``, and ``grad_fn.layer_sizes`` lists the
    leaves in ravel order. The gradient is ``lm_loss``'s on one f32 leaf
    whose views are the params, so ``leaf.grad`` is the flat row.

    ``w0`` is a flat row in the reference's layout (the reference's own
    init, carried across); without it the port draws its own init from
    ``torch.Generator().manual_seed(seed)``."""
    dev = resolve_device(device)
    fp32_products()
    cfg = configs.get(arch).reduced
    if w0 is None:
        gen = torch.Generator().manual_seed(seed)
        row = tfm.flatten_params(
            init_params(tfm.model_defs(cfg), gen, device=dev))
    else:
        row = _row_from(w0, dev)
    layout = tfm.ravel_layout(cfg)
    if row.numel() != sum(math.prod(s) for _, s in layout):
        raise ValueError(f"w0 has {row.numel()} elements, not {arch}'s")

    def _tokens(rng):
        t = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                         size=(batch, seq + 1))).to(dev)
        out = {"tokens": t[:, :-1], "targets": t[:, 1:],
               "mask": torch.ones((batch, seq), dtype=torch.float32,
                                  device=dev)}
        if cfg.mrope_sections is not None:
            # the sequence's positions on all three M-RoPE streams, as the
            # reference's problem passes them
            out["mrope_positions"] = torch.arange(
                seq, dtype=torch.int32, device=dev)[None, None].expand(
                3, batch, seq)
        return out

    rngs: dict = {}

    def grad_fn(w, step, worker):
        rng = rngs.setdefault(worker, np.random.RandomState(1000 + worker))
        leaf = w.detach().to(torch.float32).requires_grad_(True)
        loss, _ = tfm.lm_loss(cfg, tfm.unflatten(leaf, cfg), _tokens(rng))
        loss.backward()
        return leaf.grad.to(torch.float64)

    eval_batch = _tokens(np.random.RandomState(seed + 7))

    @torch.no_grad()
    def eval_fn(w):
        loss, _ = tfm.lm_loss(cfg, tfm.unflatten(w.to(torch.float32), cfg),
                              eval_batch)
        return float(loss)

    grad_fn.layer_sizes = [math.prod(s) for _, s in layout]
    return row, grad_fn, eval_fn


def make_zoo_cnn(model: str = "lenet", seed: int = 0, n_train: int = 512,
                 n_test: int = 256, batch: int = 8, noise: float = 1.6,
                 w0=None, device=None):
    """LeNet on 28×28×1 or AlexNet on 32×32×3 Gaussian-mixture images.

    ``w0`` is a flat row in the reference's layout (for instance the
    reference's own init, carried across by ``cnn.params_from_jax``);
    without it the port draws He-normal weights from
    ``torch.Generator().manual_seed(seed)``."""
    if model not in _CNNS:
        raise ValueError(f"unknown cnn '{model}' (lenet/alexnet)")
    dev = resolve_device(device)
    # The reference's math is full f32. Even in full f32 cuDNN's backward
    # algorithms put AlexNet's conv weight gradients 3.9e-5 (relative norm)
    # away from the CPU's on an H100, where PyTorch's native convolution
    # stays at 1.9e-6. So the convolutions do not go through cuDNN at all
    # (a process-wide setting).
    fp32_products()
    torch.backends.cudnn.enabled = False
    shape, init, apply = _CNNS[model]
    x, y = make_classification_dataset(n_train + n_test, shape=shape,
                                       n_classes=10, noise=noise, seed=seed)
    x = torch.from_numpy(x).to(dev)
    y = torch.from_numpy(y.astype(np.int64)).to(dev)
    xtr, ytr, xte, yte = x[:n_train], y[:n_train], x[n_train:], y[n_train:]
    if w0 is None:
        gen = torch.Generator().manual_seed(seed)
        row = cnn.flatten_params(init(gen, device=dev))
    else:
        row = _row_from(w0, dev)
    layout = cnn.ravel_layout(model)
    if row.numel() != sum(math.prod(s) for _, s in layout):
        raise ValueError(f"w0 has {row.numel()} elements, not {model}'s")

    rngs: dict = {}

    def grad_fn(w, step, worker):
        rng = rngs.setdefault(worker, np.random.RandomState(1000 + worker))
        idx = torch.from_numpy(rng.randint(0, n_train, size=batch)).to(dev)
        leaf = w.detach().to(torch.float32).requires_grad_(True)
        loss = cnn.xent_loss(apply(cnn.unflatten(leaf, model), xtr[idx]),
                             ytr[idx])
        loss.backward()
        return leaf.grad.to(torch.float64)

    @torch.no_grad()
    def eval_fn(w):
        params = cnn.unflatten(w.to(torch.float32), model)
        return 1.0 - float(cnn.accuracy(apply(params, xte), yte))

    grad_fn.layer_sizes = [math.prod(s) for _, s in layout]
    return row, grad_fn, eval_fn


def zoo_names() -> list[str]:
    """The names ``--model`` knows, as the reference's ``zoo_names`` lists
    them (its arch ids included)."""
    return (["tiny-mlp", "mlp-large", "jax-mlp", "lenet", "alexnet"]
            + sorted(configs.ARCH_IDS))


def resolve(name: str) -> ProblemSpec:
    """``--model`` name -> ProblemSpec. Every arch id of the registry
    maps to ``make_zoo_lm``."""
    fixed = {"tiny-mlp": NUMPY_MLP_MED, "mlp": NUMPY_MLP,
             "mlp-large": NUMPY_MLP_LARGE, "jax-mlp": JAX_MLP}
    if name in fixed:
        return fixed[name]
    if name in _CNNS:
        return spec("repro_torch.ps.zoo:make_zoo_cnn", model=name)
    if name in configs.ARCHS:
        return spec("repro_torch.ps.zoo:make_zoo_lm", arch=name)
    raise ValueError(f"unknown model '{name}'; have: {zoo_names()}")

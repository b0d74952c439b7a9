"""LeNet-5 and AlexNet-for-CIFAR in PyTorch (the port of
``repro/models/cnn.py``: the two CNNs, ``xent_loss`` and ``accuracy``).

The public layout is the reference's, so the tests compare like with like:

* inputs are NHWC, ``(B, H, W, C)``;
* the parameters are a dict with the reference's key names, conv weights
  in HWIO and dense weights as ``(in, out)``;
* the flat parameter row is ``jax.flatten_util.ravel_pytree``'s layout:
  keys sorted (``c1b, c1w, c2b, …, f3w`` — bias before weight), each leaf
  raveled in C order.

Inside, activations run NCHW through ``F.conv2d`` (weights permuted to
OIHW; "SAME" padding is 1 for the 3×3 kernels and 2 for LeNet's 5×5) and
``F.max_pool2d(2)``; the last feature map is flattened in NHWC order before
``f1w``, as the reference flattens it.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.utils.device import resolve_device


def param_shapes(model: str, n_classes: int = 10) -> dict:
    """``{key: (shape, fan_in)}`` in the reference's init order; ``fan_in``
    is None for a bias."""
    if model == "lenet":
        return {
            "c1w": ((5, 5, 1, 6), 25), "c1b": ((6,), None),
            "c2w": ((5, 5, 6, 16), 150), "c2b": ((16,), None),
            "f1w": ((7 * 7 * 16, 120), 784), "f1b": ((120,), None),
            "f2w": ((120, 84), 120), "f2b": ((84,), None),
            "f3w": ((84, n_classes), 84), "f3b": ((n_classes,), None),
        }
    if model == "alexnet":
        return {
            "c1w": ((3, 3, 3, 64), 27), "c1b": ((64,), None),
            "c2w": ((3, 3, 64, 192), 576), "c2b": ((192,), None),
            "c3w": ((3, 3, 192, 384), 1728), "c3b": ((384,), None),
            "c4w": ((3, 3, 384, 256), 3456), "c4b": ((256,), None),
            "c5w": ((3, 3, 256, 256), 2304), "c5b": ((256,), None),
            "f1w": ((4 * 4 * 256, 1024), 4096), "f1b": ((1024,), None),
            "f2w": ((1024, 512), 1024), "f2b": ((512,), None),
            "f3w": ((512, n_classes), 512), "f3b": ((n_classes,), None),
        }
    raise ValueError(f"unknown cnn '{model}' (lenet/alexnet)")


def ravel_layout(model: str, n_classes: int = 10) -> list:
    """``[(key, shape)]`` in flat-row order (``ravel_pytree``: sorted keys)."""
    shapes = param_shapes(model, n_classes)
    return [(k, shapes[k][0]) for k in sorted(shapes)]


def _init(model: str, generator: torch.Generator, n_classes: int, device):
    """He-normal weights, zero biases, drawn from ``generator`` on the CPU
    (the same bits on every device) and moved to ``device``. PyTorch cannot
    redraw JAX's threefry bits: runs held against the reference take its
    weights through ``params_from_jax`` instead."""
    dev = resolve_device(device)
    out = {}
    for k, (shape, fan_in) in param_shapes(model, n_classes).items():
        if fan_in is None:
            t = torch.zeros(shape)
        else:
            t = torch.randn(shape, generator=generator) * math.sqrt(
                2.0 / fan_in)
        out[k] = t.to(dev)
    return out


def lenet_init(generator: torch.Generator, n_classes: int = 10, device=None):
    return _init("lenet", generator, n_classes, device)


def alexnet_init(generator: torch.Generator, n_classes: int = 10,
                 device=None):
    return _init("alexnet", generator, n_classes, device)


def flatten_params(params: dict) -> torch.Tensor:
    """The flat f64 row in ``ravel_pytree`` order."""
    return torch.cat([params[k].reshape(-1).to(torch.float64)
                      for k in sorted(params)])


def unflatten(row: torch.Tensor, model: str, n_classes: int = 10) -> dict:
    """Views of ``row`` as the parameter dict (no copy)."""
    layout = ravel_layout(model, n_classes)
    total = sum(math.prod(shape) for _, shape in layout)
    if row.numel() != total:
        raise ValueError(f"row has {row.numel()} elements, {model} needs "
                         f"{total}")
    out, off = {}, 0
    for k, shape in layout:
        size = math.prod(shape)
        out[k] = row[off:off + size].view(shape)
        off += size
    return out


def params_from_jax(params_or_flat_row, model: str = "alexnet",
                    n_classes: int = 10, device=None):
    """Carry the reference's weights across: ``params_or_flat_row`` is the
    reference's parameter dict (numpy arrays, HWIO / (in, out)) or its flat
    ``ravel_pytree`` row. Returns ``(params, row)``: the dict as f32
    tensors in the same layout, and the flat f64 row in the same order."""
    dev = resolve_device(device)
    if isinstance(params_or_flat_row, dict):
        layout = dict(ravel_layout(model, n_classes))
        if set(params_or_flat_row) != set(layout):
            raise ValueError(f"keys {sorted(params_or_flat_row)} are not "
                             f"{model}'s {sorted(layout)}")
        params = {}
        for k, shape in layout.items():
            a = np.asarray(params_or_flat_row[k])
            if a.shape != shape:
                raise ValueError(f"{k}: shape {a.shape} != {shape}")
            params[k] = torch.from_numpy(
                np.array(a, dtype=np.float32)).to(dev)
        return params, flatten_params(params)
    row = torch.from_numpy(
        np.array(params_or_flat_row, dtype=np.float64)).to(dev)
    params = {k: v.to(torch.float32).clone()
              for k, v in unflatten(row, model, n_classes).items()}
    return params, row


def _conv(x, w, b, padding):
    """NCHW activations, HWIO weight."""
    return F.conv2d(x, w.permute(3, 2, 0, 1), b, padding=padding)


def _flatten_nhwc(h):
    return h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)


def lenet_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    """x: (B, 28, 28, 1) NHWC -> logits (B, n_classes)."""
    h = x.permute(0, 3, 1, 2)
    h = F.max_pool2d(torch.tanh(_conv(h, p["c1w"], p["c1b"], 2)), 2)
    h = F.max_pool2d(torch.tanh(_conv(h, p["c2w"], p["c2b"], 2)), 2)
    h = _flatten_nhwc(h)
    h = torch.tanh(h @ p["f1w"] + p["f1b"])
    h = torch.tanh(h @ p["f2w"] + p["f2b"])
    return h @ p["f3w"] + p["f3b"]


def alexnet_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    """x: (B, 32, 32, 3) NHWC -> logits (B, n_classes)."""
    h = x.permute(0, 3, 1, 2)
    h = F.max_pool2d(F.relu(_conv(h, p["c1w"], p["c1b"], 1)), 2)
    h = F.max_pool2d(F.relu(_conv(h, p["c2w"], p["c2b"], 1)), 2)
    h = F.relu(_conv(h, p["c3w"], p["c3b"], 1))
    h = F.relu(_conv(h, p["c4w"], p["c4b"], 1))
    h = F.max_pool2d(F.relu(_conv(h, p["c5w"], p["c5b"], 1)), 2)
    h = _flatten_nhwc(h)
    h = F.relu(h @ p["f1w"] + p["f1b"])
    h = F.relu(h @ p["f2w"] + p["f2b"])
    return h @ p["f3w"] + p["f3b"]


def xent_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logz = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(1, labels[:, None]).squeeze(1)
    return (logz - ll).mean()


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(-1) == labels).to(torch.float32).mean()

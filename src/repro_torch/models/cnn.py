"""LeNet-5, AlexNet-for-CIFAR and the small ReLU MLP in PyTorch (the port
of ``repro/models/cnn.py``: the two CNNs, ``mlp_init`` / ``mlp_apply``,
``xent_loss`` and ``accuracy``).

The public layout is the reference's, so the tests compare like with like:

* inputs are NHWC, ``(B, H, W, C)``;
* the parameters are a dict with the reference's key names, conv weights
  in HWIO and dense weights as ``(in, out)``;
* the flat parameter row is ``jax.flatten_util.ravel_pytree``'s layout:
  keys sorted (``c1b, c1w, c2b, …, f3w`` — bias before weight; the MLP's
  ``b0, b1, b_out, w0, w1, w_out``), each leaf raveled in C order. The
  MLP's widths (``d_in``, ``d_hidden``, ``depth``) ride as keyword
  arguments wherever a layout is needed.

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


def param_shapes(model: str, n_classes: int = 10, d_in: int = 64,
                 d_hidden: int = 128, depth: int = 2) -> dict:
    """``{key: (shape, fan_in)}`` in the reference's init order; ``fan_in``
    is None for a bias. ``d_in``, ``d_hidden`` and ``depth`` size the
    MLP only."""
    if model == "mlp":
        out, d = {}, d_in
        for i in range(depth):
            out[f"w{i}"] = ((d, d_hidden), d)
            out[f"b{i}"] = ((d_hidden,), None)
            d = d_hidden
        out["w_out"] = ((d, n_classes), d)
        out["b_out"] = ((n_classes,), None)
        return out
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
    raise ValueError(f"unknown model '{model}' (lenet/alexnet/mlp)")


def ravel_layout(model: str, n_classes: int = 10, **dims) -> list:
    """``[(key, shape)]`` in flat-row order (``ravel_pytree``: sorted keys)."""
    shapes = param_shapes(model, n_classes, **dims)
    return [(k, shapes[k][0]) for k in sorted(shapes)]


def _init(model: str, generator: torch.Generator, n_classes: int, device,
          **dims):
    """He-normal weights, zero biases, drawn from ``generator`` on the CPU
    (the same bits on every device) and moved to ``device``. PyTorch cannot
    redraw JAX's threefry bits: runs held against the reference take its
    weights through ``params_from_jax`` instead."""
    dev = resolve_device(device)
    out = {}
    for k, (shape, fan_in) in param_shapes(model, n_classes,
                                           **dims).items():
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


def mlp_init(generator: torch.Generator, d_in: int = 64, d_hidden: int = 128,
             n_classes: int = 10, depth: int = 2, device=None):
    """``depth`` ReLU layers of ``d_hidden`` and a linear head, in the
    reference's layout (``w{i}`` as ``(in, out)``, ``b{i}``, ``w_out``,
    ``b_out``): He-normal weights, zero biases."""
    return _init("mlp", generator, n_classes, device, d_in=d_in,
                 d_hidden=d_hidden, depth=depth)


def flatten_params(params: dict) -> torch.Tensor:
    """The flat f64 row in ``ravel_pytree`` order."""
    return torch.cat([params[k].reshape(-1).to(torch.float64)
                      for k in sorted(params)])


def unflatten(row: torch.Tensor, model: str, n_classes: int = 10,
              **dims) -> dict:
    """Views of ``row`` as the parameter dict (no copy)."""
    layout = ravel_layout(model, n_classes, **dims)
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
                    n_classes: int = 10, device=None, **dims):
    """Carry the reference's weights across: ``params_or_flat_row`` is the
    reference's parameter dict (numpy arrays, HWIO / (in, out)) or its flat
    ``ravel_pytree`` row. Returns ``(params, row)``: the dict as f32
    tensors in the same layout, and the flat f64 row in the same order.
    ``model="mlp"`` takes the MLP's widths in ``dims``."""
    dev = resolve_device(device)
    if isinstance(params_or_flat_row, dict):
        layout = dict(ravel_layout(model, n_classes, **dims))
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
              for k, v in unflatten(row, model, n_classes, **dims).items()}
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


def mlp_apply(p: dict, x: torch.Tensor, depth: int = 2) -> torch.Tensor:
    """x: (B, d_in) -> logits (B, n_classes)."""
    h = x
    for i in range(depth):
        h = F.relu(h @ p[f"w{i}"] + p[f"b{i}"])
    return h @ p["w_out"] + p["b_out"]


def xent_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logz = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(1, labels[:, None]).squeeze(1)
    return (logz - ll).mean()


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(-1) == labels).to(torch.float32).mean()

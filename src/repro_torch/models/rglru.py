"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427)
(the port of ``repro/models/rglru.py``: ``rglru_defs``, ``_causal_conv``,
``_rglru_gates``, ``rglru_scan``, ``rglru_step`` and ``rglru_block``).

Real-Gated Linear Recurrent Unit::

    r_t = σ(W_a x_t + b_a)                  (recurrence gate)
    i_t = σ(W_x x_t + b_x)                  (input gate)
    log a_t = −c · r_t · softplus(Λ)        (so a_t = σ(Λ)^{c·r_t} ∈ (0,1))
    h_t = a_t ⊙ h_{t−1} + √(1 − a_t²) ⊙ (i_t ⊙ x_t)

The gates and the recurrence run in f32. The recurrence is a log-depth
associative scan over the sequence (Hillis–Steele doubling of
``(a1·a2, a2·b1 + b2)``: ⌈log2 S⌉ steps of whole-tensor ops, 12 at S 4096),
which sums in another order than ``lax.associative_scan``'s tree, so it
agrees with the reference to f32 rounding, not bit for bit. The block
follows Griffin: two branches (GeLU gate ∥ conv1d → RG-LRU), multiplied,
projected. The reference has no Pallas kernel here, and the port has no
CUDA kernel: the scan is plain torch on either device.

Serving (``rglru_block`` with a cache ``{conv: (B, K−1, w), state: (B, w)
f32}``): the prefill keeps the last K−1 conv inputs and ``h[:, -1]``;
decode slides the conv history by one and takes the O(1) step
``rglru_step``. Both write the cache in place and return it.
``sctx.shard`` stands at the reference's points (a no-op without a
mesh).

On a mesh whose ``model`` axis splits the width (``models.tp``) the block
is a model-parallel region over the channels: ``w_y``, ``w_x``, the conv,
``ba``, ``bi`` and ``lam`` hold the rank's channels, and the scan, per
channel, runs on them alone. ``wa`` and ``wi`` split their rows, so each
gate product contracts over the rank's channels into a partial sum of
the whole width: ``tp.reduce_scatter`` sums it and keeps the rank's
channels, and its backward all-gathers the gradient (an all-reduce with
the identity backward would drop the other ranks' parts of it).
``w_out``'s contraction leaves through ``reduce_out``. Where ``model``
does not split the width every leaf is whole and every rank runs the
block. Serving on a mesh, the conv and state caches split the width as
the block does, so each rank reads and writes its own channels.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import sctx, tp
from repro_torch.models.common import ModelConfig, ParamDef, _gelu_tanh
from repro_torch.models.ssm import _causal_conv  # noqa: F401  (the same)


def rglru_defs(cfg: ModelConfig) -> dict:
    g = cfg.rglru
    d, w = cfg.d_model, g.width
    return {
        "w_y": ParamDef((d, w), ("embed", "inner")),       # gate branch
        "w_x": ParamDef((d, w), ("embed", "inner")),       # recurrent branch
        "conv_w": ParamDef((g.d_conv, w), ("conv", "inner")),
        "conv_b": ParamDef((w,), ("inner",), init="zeros"),
        "wa": ParamDef((w, w), ("inner", "inner2")),
        "ba": ParamDef((w,), ("inner",), init="zeros"),
        "wi": ParamDef((w, w), ("inner", "inner2")),
        "bi": ParamDef((w,), ("inner",), init="zeros"),
        "lam": ParamDef((w,), ("inner",), init="ones"),    # Λ
        "w_out": ParamDef((w, d), ("inner", "embed_out")),
    }


def _region() -> bool:
    lay = tp.current()
    return lay is not None and lay.rglru


def _gate(x32, w):
    """``x32 @ w`` in f32; in a model-parallel region the rank's channels
    of the sum of every rank's partial product."""
    y = x32 @ w.to(torch.float32)
    if _region():
        y = tp.reduce_scatter(y, y.dim() - 1, tp.current().model_group)
    return y


def _rglru_gates(cfg: ModelConfig, p, x):
    """-> (a, gated input), both f32 (B, S, w)."""
    g = cfg.rglru
    x32 = x.to(torch.float32)
    r = torch.sigmoid(_gate(x32, p["wa"]) + p["ba"].to(torch.float32))
    i = torch.sigmoid(_gate(x32, p["wi"]) + p["bi"].to(torch.float32))
    log_a = -g.c * r * F.softplus(p["lam"].to(torch.float32))
    a = torch.exp(log_a)
    gated_in = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i * x32)
    return a, gated_in


def linear_scan(a, b):
    """``h_t = a_t · h_{t−1} + b_t`` from ``h_{−1} = 0`` along dim 1, by
    Hillis–Steele doubling: after the step with shift s each position holds
    the combination of its last 2s elements."""
    S, shift = a.shape[1], 1
    while shift < S:
        b = torch.cat([b[:, :shift], a[:, shift:] * b[:, :-shift]
                       + b[:, shift:]], dim=1)
        if 2 * shift < S:          # the last step needs no new a
            a = torch.cat([a[:, :shift], a[:, shift:] * a[:, :-shift]],
                          dim=1)
        shift *= 2
    return b


def rglru_scan(cfg: ModelConfig, p, x):
    """x: (B, S, w) -> h: (B, S, w) f32, by the associative scan over
    time."""
    a, b = _rglru_gates(cfg, p, x)
    return linear_scan(a, b)


def rglru_step(cfg: ModelConfig, p, x_t, h_prev):
    """x_t: (B, w); h_prev: (B, w) f32 -> ``(y_t, h_t)``, both the new
    state (f32)."""
    a, b = _rglru_gates(cfg, p, x_t[:, None])
    h = a[:, 0] * h_prev + b[:, 0]
    return h, h


def rglru_block(cfg: ModelConfig, p, x, positions=None, *, cache=None,
                cache_pos=None, **_unused):
    """Griffin recurrent block -> ``(y, cache)``: the scan over the
    sequence, or with a cache and S 1 the decode step."""
    cd = cfg.compute_dtype
    region = _region()
    if region:
        x = tp.copy_in(x)
    y_gate = _gelu_tanh(sctx.shard(torch.matmul(x, p["w_y"].to(cd)),
                                   "batch", "seq", "inner"))
    xr = sctx.shard(torch.matmul(x, p["w_x"].to(cd)),
                    "batch", "seq", "inner")
    if cache is not None and x.shape[1] == 1:
        conv_hist = torch.cat([cache["conv"], xr], dim=1)       # (B, K, w)
        conv_out = torch.einsum("bkw,kw->bw", conv_hist.to(cd),
                                p["conv_w"].to(cd)) + p["conv_b"].to(cd)
        h, state = rglru_step(cfg, p, conv_out, cache["state"])
        h = h[:, None]
        cache["conv"].copy_(conv_hist[:, 1:])
        cache["state"].copy_(state)
    else:
        conv_out = _causal_conv(xr.to(cd), p["conv_w"].to(cd),
                                p["conv_b"].to(cd))
        h = rglru_scan(cfg, p, conv_out)
        if cache is not None:
            cache["conv"].copy_(xr[:, -(cfg.rglru.d_conv - 1):])
            cache["state"].copy_(h[:, -1])
    if cache is not None:
        cache = {"conv": cache["conv"], "state": cache["state"]}
    out = h.to(cd) * y_gate
    y = torch.matmul(out, p["w_out"].to(cd))
    if region:
        y = tp.reduce_out(y)
    return y, cache

"""Mixture-of-Experts FFN: top-k routing, capacity-bounded grouped
dispatch, optional shared experts (DeepSeek-V2 style), load-balance aux
loss (the port of ``repro/models/moe.py``).

The arithmetic and its order are the reference's: router logits and
softmax in f32, top-k over the probabilities (ties to the lower expert
index, as ``lax.top_k`` breaks them), the top-k renormalised by
``max(sum, 1e-9)``; tokens in ``G = _effective_groups(T,
dispatch_groups)`` groups, each with capacity ``C = ceil(Tg k
capacity_factor / E)`` slots per expert; slots run token-major with the k
choices inner, a slot's rank within its expert is the cumsum over that
order, and a slot is kept when its rank is below C. The expert products
are plain batched matmuls in the compute dtype (the reference leaves them
to XLA too). ``sctx.shard`` stands at the reference's points (a no-op
without a mesh); on a mesh whose ``data`` or ``model`` size is above 1 a
MoE config raises (``runtime.train`` / ``runtime.serve``).

Dispatch and combine are gathers, never scatter-adds, so no sum depends on
the order in which atomics land: the kept slots fill distinct buffer rows
(a buffer row no slot fills is zero, which is what the reference's
``.at[...].add(x · keep)`` leaves there, its dropped slots adding zero
into slot 0), and a dropped slot reads a zero row in the combine. Each
backward then adds into a row from one slot at most (the zero rows' own
gradients are dropped), and the k choices of a token are summed by a
reduction, so two runs of one input give the same bits.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models import sctx
from repro_torch.models.common import ModelConfig, ParamDef, act_fn


def _effective_groups(T: int, G: int) -> int:
    g = min(G, T)
    while T % g:
        g -= 1
    return max(g, 1)


def moe_defs(cfg: ModelConfig) -> dict:
    m = cfg.moe
    d, E, f = cfg.d_model, m.n_experts, m.d_expert
    defs = {
        "router": ParamDef((d, E), ("embed", "router_experts")),
        "we_gate": ParamDef((E, d, f), ("experts", "embed", "expert_ff")),
        "we_up": ParamDef((E, d, f), ("experts", "embed", "expert_ff")),
        "we_down": ParamDef((E, f, d), ("experts", "expert_ff", "embed_out")),
    }
    if m.n_shared:
        fs = m.n_shared * f
        defs.update({
            "ws_gate": ParamDef((d, fs), ("embed", "ff")),
            "ws_up": ParamDef((d, fs), ("embed", "ff")),
            "ws_down": ParamDef((fs, d), ("ff", "embed_out")),
        })
    return defs


@dataclasses.dataclass
class Routing:
    """One call's routing: ``top_p`` / ``top_e`` (G, Tg, k), ``keep`` and
    ``slot`` (G, Tg k) over the token-major slots, the aux loss, and the
    group count, tokens per group and capacity it ran at."""
    top_p: torch.Tensor
    top_e: torch.Tensor
    keep: torch.Tensor
    slot: torch.Tensor
    aux: torch.Tensor
    G: int
    Tg: int
    C: int


def top_k(probs, k: int):
    """``lax.top_k`` over the last dim: the k largest, in descending
    order, equal values in ascending index order. A stable descending
    sort keeps equal values in index order; ``torch.topk`` promises no
    order among ties."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(cfg: ModelConfig, router, x) -> Routing:
    """The routing of x (B, S, d) by the (d, E) router weights."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    E, k = m.n_experts, m.top_k
    G = _effective_groups(T, m.dispatch_groups)
    Tg = T // G
    C = max(1, math.ceil(Tg * k * m.capacity_factor / E))

    logits = torch.einsum("gtd,de->gte", x.reshape(G, Tg, d).float(),
                          router.float())
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = top_k(probs, k)                          # (G, Tg, k)
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)

    # load-balance aux loss (Switch): E · Σ_e f_e · p̄_e, f counting each
    # (token, choice) as 1 / (T k)
    me = probs.mean(dim=(0, 1))                             # (E,)
    ce = torch.bincount(top_e.reshape(-1), minlength=E).float() * (
        1.0 / (T * k))
    aux = E * torch.sum(me * ce) * m.aux_loss_weight

    ids = top_e.reshape(G, Tg * k)                          # slot -> expert
    oh = torch.nn.functional.one_hot(ids, E)                # (G, Tg k, E)
    pos = torch.gather(torch.cumsum(oh, dim=1) - 1, 2, ids[..., None])[..., 0]
    keep = pos < C
    slot = torch.where(keep, ids * C + pos, torch.zeros_like(pos))
    return Routing(top_p, top_e, keep, slot, aux, G, Tg, C)


def _rows(src, idx):
    """Rows ``idx`` (G, n) of ``src`` (G, m, d), per group: one
    ``index_select`` over the flattened groups."""
    G, M, d = src.shape
    flat = (idx + torch.arange(G, device=idx.device)[:, None] * M).reshape(-1)
    return src.reshape(G * M, d).index_select(0, flat).reshape(
        G, idx.shape[1], d)


def moe_block(cfg: ModelConfig, p, x):
    """x: (B, S, d) -> (y, aux_loss)."""
    m = cfg.moe
    cd = cfg.compute_dtype
    act = act_fn(cfg.act)
    B, S, d = x.shape
    E, k = m.n_experts, m.top_k
    r = route(cfg, p["router"], x)
    G, Tg, C, n = r.G, r.Tg, r.C, r.Tg * k

    # ---- grouped dispatch: buffer row e C + c takes the slot ranked c for
    # expert e, or the zero row n past the slots ------------------------------
    x_slots = x.to(cd).reshape(G, Tg, 1, d).expand(G, Tg, k, d)
    x_slots = torch.cat([x_slots.reshape(G, n, d),
                         x_slots.new_zeros((G, 1, d))], dim=1)
    fill = torch.full((G, E * C + 1), n, dtype=torch.int64, device=x.device)
    fill.scatter_(1, torch.where(r.keep, r.slot, E * C),
                  torch.arange(n, device=x.device).expand(G, n))
    ex = "experts_dp" if cfg.moe_ep else "experts_off"
    buf = sctx.shard(_rows(x_slots, fill[:, :E * C]).reshape(G, E, C, d),
                     "groups", ex, "cap", "embed")

    # ---- expert FFN ---------------------------------------------------------
    h = act(sctx.shard(
        torch.einsum("gecd,edf->gecf", buf, p["we_gate"].to(cd)),
        "groups", ex, "cap", "ff")) * \
        torch.einsum("gecd,edf->gecf", buf, p["we_up"].to(cd))
    out = torch.einsum("gecf,efd->gecd", h, p["we_down"].to(cd))

    # ---- combine: a dropped slot reads the zero row E C ---------------------
    out = sctx.shard(out.reshape(G, E * C, d), "groups", "cap", "embed")
    out = torch.cat([out, out.new_zeros((G, 1, d))], 1)
    y_slots = _rows(out, torch.where(r.keep, r.slot, E * C))
    w = (r.top_p.reshape(G, n) * r.keep.to(torch.float32)).to(cd)
    y = (y_slots * w[..., None]).reshape(G, Tg, k, d).sum(dim=2)
    y = y.reshape(B, S, d)

    # ---- shared experts (always-on dense path) ------------------------------
    if m.n_shared:
        g = act(sctx.shard(
            torch.einsum("bsd,df->bsf", x, p["ws_gate"].to(cd)),
            "batch", "seq", "ff"))
        u = sctx.shard(torch.einsum("bsd,df->bsf", x, p["ws_up"].to(cd)),
                       "batch", "seq", "ff")
        y = y + torch.einsum("bsf,fd->bsd", g * u, p["ws_down"].to(cd))
    return sctx.shard(y, "batch", "seq", "embed"), r.aux

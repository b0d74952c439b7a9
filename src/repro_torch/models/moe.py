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
without a mesh).

On a mesh (``models.tp``) a rank holds its rows of the microbatch, and the
reference routes the whole microbatch: ``G`` and ``C`` come from every
token of it, group g holding tokens ``[g Tg, (g +
1) Tg)`` in row-major ``(B, S)`` order. Where ``G`` splits over ``data``
the rank routes its own groups; else it all-gathers the microbatch's
tokens over ``data`` (the backward a reduce-scatter), routes and
dispatches every group, and keeps its own rows of the combine. With the
experts over ``data`` (EP) the ``(G_local, E, C, d)`` buffer goes to
``(G, E / data, C, d)`` by one ``tp.all_to_all`` (the reference's
``"groups" -> "experts_dp"`` reshard), the rank's experts run, and a
second all-to-all brings the slots back token-major (with the groups
whole on every rank, the rank takes its experts' slice of the buffer and
all-gathers their outputs instead). Experts that ``data`` does not split
run whole on each rank (FSDP gathers their ``embed`` dim). ``expert_ff``
over ``model`` makes the expert FFN a model-parallel region (``copy_in``
on the buffer, ``reduce_out`` on ``we_down``'s contraction), as the
shared experts' ``ff`` does. The aux loss is ``E Σ_e me_e ce_e`` over the
whole microbatch: each rank's is its share, ``E Σ_e (its probabilities'
sum_e / T) ce_e`` with the choice counts ``ce`` (no gradient) summed over
``data``, so the shares sum over ``data`` to the reference's aux and its
gradient.

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

from repro_torch.models import sctx, tp
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


def capacity(m, Tg: int) -> int:
    return max(1, math.ceil(Tg * m.top_k * m.capacity_factor
                            / m.n_experts))


def route(cfg: ModelConfig, router, x, G: int | None = None,
          C: int | None = None, aux_share=None) -> Routing:
    """The routing of x (..., d) by the (d, E) router weights, in ``G``
    groups of capacity ``C`` (by default those of x's own tokens).
    ``aux_share(probs, counts)`` (a mesh) returns the aux loss's ``(me,
    ce)`` in place of the means over x."""
    m = cfg.moe
    d = x.shape[-1]
    T = x.numel() // d
    E, k = m.n_experts, m.top_k
    if G is None:
        G = _effective_groups(T, m.dispatch_groups)
    Tg = T // G
    if C is None:
        C = capacity(m, Tg)

    logits = torch.einsum("gtd,de->gte", x.reshape(G, Tg, d).float(),
                          router.float())
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = top_k(probs, k)                          # (G, Tg, k)
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)

    ids = top_e.reshape(G, Tg * k)                          # slot -> expert
    oh = torch.nn.functional.one_hot(ids, E)                # (G, Tg k, E)
    # load-balance aux loss (Switch): E · Σ_e f_e · p̄_e, f counting each
    # (token, choice) as 1 / (T k)
    counts = oh.sum(dim=(0, 1)).float()
    if aux_share is None:
        me, ce = probs.mean(dim=(0, 1)), counts * (1.0 / (T * k))
    else:
        me, ce = aux_share(probs, counts)
    aux = E * torch.sum(me * ce) * m.aux_loss_weight

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


def _mesh_route(cfg: ModelConfig, router, x, lay):
    """``(x_routed, routing, rows)`` on a mesh: the tokens this rank routes
    (its own groups, or every rank's tokens gathered over ``data``), their
    routing at the microbatch's ``G`` and ``C`` with this rank's share of
    the aux loss, and the slice of the routed rows that are its own (None:
    all of them, each rank routing its own groups). Where every rank
    holds every row (``Layout.data_rows`` off: serving a batch that
    ``data`` does not split) it routes them all as one device would, and
    its aux loss is the whole batch's."""
    m = cfg.moe
    B, S, d = x.shape
    if not lay.data_rows:
        # serving with B not a multiple of data: every rank holds every
        # row, so its tokens are the whole batch's
        return x, route(cfg, router, x), slice(None)
    T, D = B * S, lay.data_size
    # the reference counts the groups and their capacity from every token
    # of the microbatch
    G = _effective_groups(T * D, m.dispatch_groups)
    split = G % D == 0
    C = capacity(m, T * D // G)
    if split:
        gl, rows, mine = G // D, None, slice(None)
    else:
        x = tp.all_gather(x, 0, lay.data_group)
        gl, rows = G, slice(lay.data_rank * B, (lay.data_rank + 1) * B)
        mine = slice(lay.data_rank * T, (lay.data_rank + 1) * T)

    def share(probs, counts):
        counts = counts if not split else tp.data_sum(counts, lay)
        own = probs.reshape(-1, m.n_experts)[mine].sum(0)
        return own / (T * D), counts.detach() * (1.0 / (T * D * m.top_k))
    r = route(cfg, router, x, gl, C, aux_share=share)
    return x, r, rows


def _experts(cfg: ModelConfig, p, buf, lay):
    """The expert FFN on ``buf`` (G, E', C, d): E' the experts this rank
    holds; a model-parallel region where ``model`` splits ``expert_ff``."""
    cd = cfg.compute_dtype
    act = act_fn(cfg.act)
    region = lay is not None and lay.expert_ff
    if region:
        buf = tp.copy_in(buf)
    ex = "experts_dp" if cfg.moe_ep else "experts_off"
    h = act(sctx.shard(
        torch.einsum("gecd,edf->gecf", buf, p["we_gate"].to(cd)),
        "groups", ex, "cap", "ff")) * \
        torch.einsum("gecd,edf->gecf", buf, p["we_up"].to(cd))
    out = torch.einsum("gecf,efd->gecd", h, p["we_down"].to(cd))
    return tp.reduce_out(out) if region else out


def moe_block(cfg: ModelConfig, p, x):
    """x: (B, S, d) -> (y, aux_loss)."""
    m = cfg.moe
    cd = cfg.compute_dtype
    act = act_fn(cfg.act)
    B, S, d = x.shape
    E, k = m.n_experts, m.top_k
    lay = tp.current()
    rows = None
    if lay is None:
        xr, r = x, route(cfg, p["router"], x)
    else:
        xr, r, rows = _mesh_route(cfg, p["router"], x, lay)
    G, Tg, C, n = r.G, r.Tg, r.C, r.Tg * k

    # ---- grouped dispatch: buffer row e C + c takes the slot ranked c for
    # expert e, or the zero row n past the slots ------------------------------
    x_slots = xr.to(cd).reshape(G, Tg, 1, d).expand(G, Tg, k, d)
    x_slots = torch.cat([x_slots.reshape(G, n, d),
                         x_slots.new_zeros((G, 1, d))], dim=1)
    fill = torch.full((G, E * C + 1), n, dtype=torch.int64, device=x.device)
    fill.scatter_(1, torch.where(r.keep, r.slot, E * C),
                  torch.arange(n, device=x.device).expand(G, n))
    ex = "experts_dp" if cfg.moe_ep else "experts_off"
    buf = sctx.shard(_rows(x_slots, fill[:, :E * C]).reshape(G, E, C, d),
                     "groups", ex, "cap", "embed")

    # ---- expert FFN, on the rank's experts under EP ------------------------
    if lay is not None and lay.experts:
        grp, el = lay.data_group, E // lay.data_size
        if rows is None:
            out = tp.all_to_all(_experts(cfg, p, tp.all_to_all(
                buf, 1, 0, grp), lay), 0, 1, grp)
        else:
            mine = buf.narrow(1, lay.data_rank * el, el)
            out = tp.all_gather(_experts(cfg, p, mine, lay), 1, grp)
    else:
        out = _experts(cfg, p, buf, lay)

    # ---- combine: a dropped slot reads the zero row E C ---------------------
    out = sctx.shard(out.reshape(G, E * C, d), "groups", "cap", "embed")
    out = torch.cat([out, out.new_zeros((G, 1, d))], 1)
    y_slots = _rows(out, torch.where(r.keep, r.slot, E * C))
    w = (r.top_p.reshape(G, n) * r.keep.to(torch.float32)).to(cd)
    y = (y_slots * w[..., None]).reshape(G, Tg, k, d).sum(dim=2)
    y = y.reshape(-1, S, d)
    if rows is not None:
        y = y[rows]

    # ---- shared experts (always-on dense path) ------------------------------
    if m.n_shared:
        region = lay is not None and lay.shared_ff
        xs = tp.copy_in(x) if region else x
        g = act(sctx.shard(
            torch.einsum("bsd,df->bsf", xs, p["ws_gate"].to(cd)),
            "batch", "seq", "ff"))
        u = sctx.shard(torch.einsum("bsd,df->bsf", xs, p["ws_up"].to(cd)),
                       "batch", "seq", "ff")
        ys = torch.einsum("bsf,fd->bsd", g * u, p["ws_down"].to(cd))
        y = y + (tp.reduce_out(ys) if region else ys)
    return sctx.shard(y, "batch", "seq", "embed"), r.aux

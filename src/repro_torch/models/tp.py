"""Tensor and data parallelism on local shards: the collectives a layer
runs on a ``(pod, data, model)`` mesh of processes.

On a mesh the port's model runs on each rank's local shards, laid out by
``runtime.sharding.param_specs``: q heads (and kv heads, where their count
divides it; MLA's heads), the FFN's ``ff`` dim, the vocabulary, the SSM
heads and ``d_inner``, the RG-LRU width and each expert's ``ff`` dim over
``model``; the batch, and the MoE experts (EP, where their count divides
it), over ``data``. Every redistribution the reference leaves to GSPMD
is explicit here, at the points of the reference's ``sctx.shard`` calls:

* ``copy_in(x)``: a replicated tensor entering a model-parallel region
  (forward the identity, backward the all-reduce of its gradient over
  ``model``). The region's inputs take it: the activation, and any
  replicated parameter the region reads (kv projections that ``model``
  cannot split, the qk-norm scales), whose gradients are otherwise
  partial sums over the ranks' heads;
* ``reduce_out(y)``: a partial sum over ``model`` leaving the region (the
  output projections' contraction over local heads or ``ff``, the masked
  embedding lookup): forward the all-reduce, backward the identity;
* ``all_gather(x, dim, group)``: the streaming-FSDP gather of one layer's
  weights over ``data``, whose backward is the reduce-scatter; also a
  model-split leaf that every rank reads whole for its own part (the
  SSM's mixed ``w_in`` and conv columns), and the MoE buffers over
  ``data`` where the dispatch groups do not split over it;
* ``reduce_scatter(x, dim, group)``: partial sums of a full-width
  activation, each rank keeping its block (the RG-LRU gates, whose
  products contract over the rank's channels): the backward is the
  all-gather;
* ``all_to_all(x, split_dim, cat_dim, group)``: the expert-parallel
  dispatch over ``data`` (``split_dim``'s blocks go to the ranks in order,
  the received blocks join along ``cat_dim``); the backward is the
  reverse all-to-all;
* ``model_sum(x)``: a statistic that every rank's channels both feed and
  read (the gated norm's variance over a split ``d_inner``): forward and
  backward the all-reduce over ``model``;
* ``gather_whole(x, dim, group)``: a model-split leaf of a block that every
  rank computes whole (a kind whose heads do not split): the backward
  keeps the rank's own block of the identical gradients;
* ``data_sum``: a detached metric summed over ``data``;
* ``softmax_combine(m, l, o, split)``: serving's flash-decoding, the
  partial softmax terms of each rank's block of a cache whose time dim
  the cache specs split (``TimeSplit``) finished over the axes that split
  it: the counterpart of GSPMD's reduction of the reference's
  ``decode_attention`` over a sharded time dim.

``use(layout)`` installs the rank's ``Layout`` for a forward; without one
(one device, or a mesh whose ``data`` and ``model`` sizes are 1) every
function here is the identity, so that path is the un-meshed one op for
op.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.utils import opcount_hook

_ctx = contextvars.ContextVar("tensor_parallel", default=None)


@dataclasses.dataclass(frozen=True)
class TimeSplit:
    """One serving cache's time dim split over mesh axes
    (``runtime.sharding.time_splits``): the axes in the spec's nesting
    order (``data`` outside ``model``) with their process groups, this
    rank's block index (``data_rank · model_size + model_rank`` over
    both), the block's slots and the whole dim's."""
    axes: tuple
    groups: tuple
    index: int
    block: int
    length: int

    @property
    def offset(self) -> int:
        """The global slot of the block's first."""
        return self.index * self.block

    @property
    def over_model(self) -> bool:
        return "model" in self.axes


@dataclasses.dataclass(frozen=True)
class Layout:
    """One rank's place on the mesh and what its params shard."""
    model_group: Any
    model_size: int
    model_rank: int
    data_group: Any
    data_size: int
    heads: bool            # q heads over model (a TP attention or MLA block)
    kv_heads: bool         # kv heads over model too
    ff: bool               # the FFN's ff dim over model
    vocab: bool            # the vocabulary over model
    n_heads: int
    n_kv_heads: int
    vocab_size: int
    data_rank: int = 0
    ssm_heads: bool = False    # the SSM heads (and d_inner) over model
    rglru: bool = False        # the RG-LRU width over model
    experts: bool = False      # the MoE experts over data (EP)
    expert_ff: bool = False    # each expert's ff dim over model
    shared_ff: bool = False    # the shared experts' ff dim over model
    data_rows: bool = True     # data splits the batch rows (serving: B a
    #                            multiple of data; else every rank holds all)
    time: tuple = ()           # serving: (cache name, TimeSplit) pairs

    def time_split(self, name: str) -> TimeSplit | None:
        """The time split of cache ``name`` (``attn``, ``local``, ``ckv``,
        ``kpe``), or None where its time dim is whole on every rank."""
        return dict(self.time).get(name)

    @property
    def vocab_start(self) -> int:
        return self.model_rank * (self.vocab_size // self.model_size) \
            if self.vocab else 0

    def kv_index(self):
        """The global kv heads this rank's q heads read, when ``model``
        splits the q heads but not the kv heads (GQA): head h reads kv head
        ``h // (H / KVH)``. Returns the kv indices to take from the
        replicated projection: one per kv group when the rank's heads fill
        whole groups or share one, else one per q head."""
        hl = self.n_heads // self.model_size
        group = self.n_heads // self.n_kv_heads
        heads = range(self.model_rank * hl, (self.model_rank + 1) * hl)
        per_head = [h // group for h in heads]
        uniq = sorted(set(per_head))
        if hl % len(uniq) == 0 and per_head == [
                u for u in uniq for _ in range(hl // len(uniq))]:
            return uniq
        return per_head


def layout_for(cfg, mesh) -> Layout | None:
    """The rank's ``Layout`` on ``mesh`` for ``cfg``; None when the mesh's
    ``data`` and ``model`` sizes are 1 (nothing to split)."""
    from repro_torch.launch.mesh import axis_sizes
    from repro_torch.models.common import make_rules
    sizes = axis_sizes(mesh)
    msz, dsz = sizes.get("model", 1), sizes.get("data", 1)
    if msz == 1 and dsz == 1:
        return None

    def split(n):
        return msz > 1 and n % msz == 0
    rules = make_rules(cfg, sizes)
    kinds = set(cfg.pattern) | set(cfg.remainder_kinds)
    extra = {}
    if "ssm" in kinds:
        s = cfg.ssm
        extra["ssm_heads"] = split(s.expand * cfg.d_model // s.head_dim)
    if "rglru" in kinds:
        extra["rglru"] = split(cfg.rglru.width)
    if cfg.moe is not None:
        m = cfg.moe
        extra.update(experts=dsz > 1 and rules["experts"] == "data",
                     expert_ff=split(m.d_expert),
                     shared_ff=bool(m.n_shared)
                     and split(m.n_shared * m.d_expert))
    return Layout(
        model_group=mesh.get_group("model") if msz > 1 else None,
        model_size=msz,
        model_rank=mesh.get_local_rank("model") if msz > 1 else 0,
        data_group=mesh.get_group("data") if dsz > 1 else None,
        data_size=dsz,
        heads=split(cfg.n_heads), kv_heads=split(cfg.n_kv_heads),
        ff=split(cfg.d_ff), vocab=split(cfg.vocab_size),
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        vocab_size=cfg.vocab_size,
        data_rank=mesh.get_local_rank("data") if dsz > 1 else 0, **extra)


def current() -> Layout | None:
    return _ctx.get()


@contextlib.contextmanager
def use(layout: Layout | None):
    token = _ctx.set(layout)
    try:
        yield
    finally:
        _ctx.reset(token)


def _all_reduce(x: torch.Tensor, group):
    out = torch.clone(x, memory_format=torch.contiguous_format)
    opcount_hook.collective("all-reduce", out, group)
    dist.all_reduce(out, group=group)
    return out


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_in(x, layout: Layout | None = None):
    lay = layout or current()
    if lay is None or lay.model_group is None:
        return x
    return _CopyIn.apply(x, lay.model_group)


def reduce_out(x, layout: Layout | None = None):
    lay = layout or current()
    if lay is None or lay.model_group is None:
        return x
    return _ReduceOut.apply(x, lay.model_group)


class _ModelSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def model_sum(x, layout: Layout | None = None):
    """The sum of ``x`` over ``model``, forward and backward: every rank
    reads the sum, and each rank's part of it feeds every rank's loss."""
    lay = layout or current()
    if lay is None or lay.model_group is None:
        return x
    return _ModelSum.apply(x, lay.model_group)


def data_sum(x, layout: Layout | None = None):
    """A detached sum over ``data`` (metrics)."""
    lay = layout or current()
    if lay is None or lay.data_group is None:
        return x
    return _all_reduce(x.detach(), lay.data_group)


# torch 2.13 renames these two collectives (the old names warn and call
# the new); the card's torch 2.11 has the old names only
_gather_single = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_scatter_single = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def gather_dim(x, dim: int, group):
    """The blocks of ``x`` on the group's ranks, in rank order along
    ``dim`` (no autograd)."""
    n = dist.get_world_size(group)
    xm = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xm.shape[0],) + tuple(xm.shape[1:]),
                      dtype=x.dtype, device=x.device)
    opcount_hook.collective("all-gather", out, group)
    _gather_single(out, xm, group=group)
    return out.movedim(0, dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        gm = g.movedim(ctx.dim, 0).contiguous()
        out = torch.empty((gm.shape[0] // n,) + tuple(gm.shape[1:]),
                          dtype=g.dtype, device=g.device)
        opcount_hook.collective("reduce-scatter", out, ctx.group)
        _scatter_single(out, gm, group=ctx.group)
        return out.movedim(0, ctx.dim), None, None


def all_gather(x, dim: int, group):
    """All-gather ``x`` along ``dim`` over ``group``; the backward
    reduce-scatters the gradient (sums it over the group's ranks)."""
    return _AllGather.apply(x, dim, group)


def scatter_dim(x, dim: int, group):
    """The sum of ``x`` over the group's ranks, this rank's block along
    ``dim`` (no autograd)."""
    n = dist.get_world_size(group)
    xm = x.movedim(dim, 0).contiguous()
    out = torch.empty((xm.shape[0] // n,) + tuple(xm.shape[1:]),
                      dtype=x.dtype, device=x.device)
    opcount_hook.collective("reduce-scatter", out, group)
    _scatter_single(out, xm, group=group)
    return out.movedim(0, dim)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return scatter_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return gather_dim(g, ctx.dim, ctx.group), None, None


def reduce_scatter(x, dim: int, group):
    """Sum ``x`` over ``group`` and keep this rank's block along ``dim``;
    the backward all-gathers the gradient."""
    return _ReduceScatter.apply(x, dim, group)


def _exchange(x, split_dim: int, cat_dim: int, group):
    n = dist.get_world_size(group)
    xm = x.movedim(split_dim, 0).contiguous()
    out = torch.empty_like(xm)
    opcount_hook.collective("all-to-all", out, group)
    dist.all_to_all_single(out, xm, group=group)
    # block i of out came from rank i: (n, c, rest) with x's dims back in
    # place, then the n blocks joined along cat_dim
    out = out.reshape((n, xm.shape[0] // n) + tuple(xm.shape[1:]))
    out = out.movedim(1, split_dim + 1).movedim(0, cat_dim)
    shape = list(out.shape)
    shape[cat_dim:cat_dim + 2] = [shape[cat_dim] * shape[cat_dim + 1]]
    return out.reshape(shape)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, cat_dim, group):
        ctx.dims, ctx.group = (split_dim, cat_dim), group
        return _exchange(x, split_dim, cat_dim, group)

    @staticmethod
    def backward(ctx, g):
        split_dim, cat_dim = ctx.dims
        return _exchange(g, cat_dim, split_dim, ctx.group), None, None, None


def all_to_all(x, split_dim: int, cat_dim: int, group):
    """Block ``j`` of ``x`` along ``split_dim`` goes to rank ``j`` of
    ``group``; the blocks this rank receives join along ``cat_dim`` in rank
    order. The backward is the reverse all-to-all."""
    return _AllToAll.apply(x, split_dim, cat_dim, group)


class _GatherWhole(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        ctx.block = x.shape[dim]
        return gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        r = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, r * ctx.block, ctx.block), None, None


def gather_whole(x, dim: int, group):
    """All-gather ``x`` along ``dim`` for a computation that every rank of
    ``group`` runs whole: each rank's gradient is already the whole one,
    so the backward keeps this rank's block of it."""
    return _GatherWhole.apply(x, dim, group)


COMBINE = "softmax-combine"      # the combine's tag in an op count


def _combine_weight(m, M, split: TimeSplit):
    """``e^{m_r − M}``: a rank's share of the combined softmax (0 for a
    block with no valid slot, whose ``m_r`` is the finite ``NEG_INF``)."""
    return torch.exp(m - M)


def softmax_combine(m, l, o, split: TimeSplit):
    """Flash-decoding's combine over the axes of ``split``: each rank holds
    its block's running max ``m`` (...), its sum ``l = Σ e^{s−m}`` over its
    valid slots (...) and its un-normalised ``o = Σ e^{s−m} v`` (..., D);
    the result is ``Σ e^{m_r−M} o_r / Σ e^{m_r−M} l_r`` with ``M = max
    m_r``, the softmax-weighted sum over the whole time dim (no autograd:
    serving). Two all-reduces a group: the max, then the rescaled terms
    and sums in one tensor."""
    M = m.clone()
    for g in split.groups:
        opcount_hook.collective("all-reduce", M, g, tag=COMBINE)
        dist.all_reduce(M, op=dist.ReduceOp.MAX, group=g)
    w = _combine_weight(m, M, split)
    both = torch.cat([o * w[..., None], (l * w)[..., None]], dim=-1)
    for g in split.groups:
        opcount_hook.collective("all-reduce", both, g, tag=COMBINE)
        dist.all_reduce(both, group=g)
    return both[..., :-1] / both[..., -1:]

"""Tensor and data parallelism on local shards: the collectives a layer
runs on a ``(pod, data, model)`` mesh of processes.

On a mesh the port's model runs on each rank's local shards, laid out by
``runtime.sharding.param_specs``: q heads (and kv heads, where their count
divides it), the FFN's ``ff`` dim and the vocabulary over ``model``; the
batch over ``data``. Every redistribution the reference leaves to GSPMD
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
  weights over ``data``, whose backward is the reduce-scatter;
* ``data_sum``: a detached metric summed over ``data``.

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
class Layout:
    """One rank's place on the mesh and what its params shard."""
    model_group: Any
    model_size: int
    model_rank: int
    data_group: Any
    data_size: int
    heads: bool            # q heads over model (a TP attention block)
    kv_heads: bool         # kv heads over model too
    ff: bool               # the FFN's ff dim over model
    vocab: bool            # the vocabulary over model
    n_heads: int
    n_kv_heads: int
    vocab_size: int

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
    sizes = axis_sizes(mesh)
    msz, dsz = sizes.get("model", 1), sizes.get("data", 1)
    if msz == 1 and dsz == 1:
        return None

    def split(n):
        return msz > 1 and n % msz == 0
    return Layout(
        model_group=mesh.get_group("model") if msz > 1 else None,
        model_size=msz,
        model_rank=mesh.get_local_rank("model") if msz > 1 else 0,
        data_group=mesh.get_group("data") if dsz > 1 else None,
        data_size=dsz,
        heads=split(cfg.n_heads), kv_heads=split(cfg.n_kv_heads),
        ff=split(cfg.d_ff), vocab=split(cfg.vocab_size),
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        vocab_size=cfg.vocab_size)


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

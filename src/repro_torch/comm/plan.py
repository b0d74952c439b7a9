"""ExchangePlan: schedule × packing × compression × overlap as ONE object
(the port of ``repro/comm/plan.py``).

The plan is what the multi-pod step consumes for the cross-pod exchange.
On one device the P pods are the rows of one tensor, so the plan's
collective is a sum over rows (``Schedule.allreduce``):

 * ``reduce_mean_flat(delta, ef)`` — the packed exchange of
   ``core.elastic``: ``(P, n)`` rows -> their mean ``(n,)``, through the
   compression (each pod row encoded with its own error feedback, every
   payload leaf summed over the rows, divided by the pod count, decoded);
 * ``exchange(tree)`` — a pytree whose leaves carry a leading pod dim ->
   the cross-pod mean pytree, packed into one buffer per pod (§5.2);
 * ``cost_s`` / ``visible_cost_s`` — the same exchange under the α–β
   model; ``overlap`` (§6.1.3) decides whether compute hides it.

On a mesh whose ``pod`` axis is above 1 the plan carries that axis's
process ``group`` (the reference's ``axis_name``): each rank sums its local
pod rows and ONE collective runs over the group, ``psum`` as
``all_reduce`` and ``ring`` as its rounds (``comm.rounds.ring_rounds``)
over ``batch_isend_irecv``. ``start_reduce_mean_flat`` issues the
``all_reduce`` with ``async_op=True`` and returns the call that waits on
it: the overlapped step issues it before the gradients. Other schedules
raise on such a group (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.comm import rounds as rounds_lib
from repro_torch.comm import schedules as schedules_lib
from repro_torch.core import compression as compression_lib
from repro_torch.core import costmodel
from repro_torch.core import packing as packing_lib
from repro_torch.models.common import tree_leaves_with_path, tree_unflatten
from repro_torch.utils import opcount_hook


@dataclasses.dataclass(frozen=True)
class ExchangePlan:
    """A fully-composed cross-pod exchange among ``n_total`` pods."""

    schedule: schedules_lib.Schedule
    compression: compression_lib.Compression
    overlap: bool = True
    n_total: int = 1
    # two-level fabric for pricing only; None prices the flat model
    topology: costmodel.Topology | None = None
    # the pod axis's process group on a mesh (None: every pod row local)
    group: Any = None

    def allreduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``(P, ...)`` pod rows through the plan's schedule."""
        return self.schedule.allreduce(x)

    def reduce_mean_flat(self, delta: torch.Tensor, ef=None):
        """Cross-pod mean of packed rows: ``(P, n)`` -> ``((n,), new_ef)``.
        ``ef`` is the error-feedback state (required when compression is
        on, shaped like ``delta``)."""
        if self.group is not None or self.compression.name != "none":
            return self.start_reduce_mean_flat(delta, ef)()
        # in place on the fresh sum: one (n,) buffer at full width
        return self.allreduce_sum(delta).div_(self._divisor(delta)), ef

    def _divisor(self, delta: torch.Tensor) -> torch.Tensor:
        # a 0-d divisor on the rows' device (CUDA's division by a Python
        # scalar multiplies by its reciprocal); a fill, not a host copy
        return torch.full((), float(max(self.n_total, 1)),
                          dtype=torch.float32, device=delta.device)

    def _sum(self, rows: torch.Tensor):
        """Sum ``(P_local, ...)`` pod rows over every pod: ``(sum, work)``,
        where ``work`` is an ``all_reduce`` still in flight over the pod
        group (psum) or None once the sum is whole (the rows' schedule
        without a group, ring over one)."""
        if self.group is None:
            return self.allreduce_sum(rows), None
        # one local pod: its row itself (no second row-sized buffer)
        local = rows[0] if rows.shape[0] == 1 else rows.sum(0,
                                                            dtype=rows.dtype)
        if self.schedule.name == "psum":
            opcount_hook.collective("all-reduce", local, self.group)
            return local, dist.all_reduce(local, group=self.group,
                                          async_op=True)
        _ring_allreduce(local, self.group)
        return local, None

    def start_reduce_mean_flat(self, delta: torch.Tensor, ef=None):
        """``reduce_mean_flat``, started: every sum issued (over the pod
        group, the one collective of each payload leaf in flight). Returns
        ``finish()``, which waits on them and returns ``(mean (n,),
        new_ef)``."""
        div = self._divisor(delta)
        if self.compression.name == "none":
            total, work = self._sum(delta)

            def finish():
                if work is not None:
                    work.wait()
                return total.div_(div), ef
            return finish
        if ef is None:
            raise ValueError("compression requires error-feedback state")
        encoded = [self.compression.encode(d, e) for d, e in zip(delta, ef)]
        ef_new = torch.stack([e for _, e in encoded])
        # int8 signs stay int8 on the wire, as the reference's _sum_local
        sums = [self._sum(torch.stack(leaf))
                for leaf in zip(*(p for p, _ in encoded))]

        def finish():
            for _, w in sums:
                if w is not None:
                    w.wait()
            return self.compression.decode_mean(
                [x.to(torch.float32).div_(div) for x, _ in sums]), ef_new
        return finish

    def exchange(self, tree):
        """Weights with a leading pod dim -> their cross-pod mean, as ONE
        packed buffer per pod. Stateless: with compression on, error
        feedback starts from zero and is discarded."""
        leaves = [leaf for _, leaf in tree_leaves_with_path(tree)]
        p = leaves[0].shape[0]
        packer = packing_lib.Packer(tree_unflatten(tree, [
            leaf[0] for leaf in leaves]), align=1)
        delta = torch.stack([packer.pack(tree_unflatten(
            tree, [leaf[i] for leaf in leaves])) for i in range(p)])
        ef = (torch.zeros_like(delta)
              if self.compression.name != "none" else None)
        mean, _ = self.reduce_mean_flat(delta, ef)
        return packer.unpack(mean)

    # -- the same exchange under the α–β model ------------------------------
    def wire_bytes(self, n_elements: int) -> float:
        """Bytes the reduction over pod rows moves after compression
        (sign_ef signs stay int8: one byte per element)."""
        return n_elements * self.compression.jit_wire_bytes_per_element

    def framed_wire_bytes(self, n_elements: int) -> float:
        """Bytes on a framed point-to-point wire (``net``): sign_ef signs
        bit-packed."""
        return n_elements * self.compression.wire_bytes_per_element

    def cost_s(self, n_elements: int, net: costmodel.Network,
               p: int | None = None) -> float:
        """α–β time of one exchange of ``n_elements`` packed f32 elements;
        with a non-uniform ``topology`` the rounds are priced per link
        class."""
        nb = self.wire_bytes(n_elements)
        np_ = p if p is not None else self.n_total
        if self.topology is not None and not self.topology.uniform:
            return self.schedule.cost_topo(nb, np_, self.topology)
        return self.schedule.cost(nb, np_, net)

    def visible_cost_s(self, n_elements: int, net: costmodel.Network,
                       t_compute: float, p: int | None = None) -> float:
        """Exchange time not hidden by compute: with overlap (§6.1.3) the
        exchange reads start-of-step weights and hides behind the
        gradients; without it the full cost is serialised."""
        t = self.cost_s(n_elements, net, p)
        return max(t - t_compute, 0.0) if self.overlap else t


def _ring_allreduce(x: torch.Tensor, group) -> None:
    """Sum ``x`` over ``group`` in place by the ring schedule's rounds:
    reduce-scatter, then all-gather, each round's sends and receives posted
    together (``batch_isend_irecv``), every receiver reading its sender's
    pre-round chunk."""
    p, me = dist.get_world_size(group), dist.get_rank(group)
    ranks = dist.get_process_group_ranks(group)
    flat = x.reshape(-1)
    m = flat.numel()
    buf = torch.zeros(m + (-m) % p, dtype=x.dtype, device=x.device)
    buf[:m] = flat
    for rnd in rounds_lib.ring_rounds(p):
        ops, recvs = [], []
        for msg in rnd:
            a, b = msg.span(buf.numel())
            if msg.src == me:
                opcount_hook.collective("collective-permute", buf[a:b],
                                        group)
                ops.append(dist.P2POp(dist.isend, buf[a:b], ranks[msg.dst],
                                      group))
            if msg.dst == me:
                t = torch.empty(b - a, dtype=x.dtype, device=x.device)
                ops.append(dist.P2POp(dist.irecv, t, ranks[msg.src], group))
                recvs.append((msg.op, a, b, t))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        for op, a, b, t in recvs:
            if op == "add":
                buf[a:b] += t
            else:
                buf[a:b].copy_(t)
    flat.copy_(buf[:m])


GROUP_SCHEDULES = ("psum", "ring")


def make_plan(schedule: str = "psum", compression: str = "none",
              overlap: bool = True, n_total: int = 1,
              topology: costmodel.Topology | None = None,
              group=None) -> ExchangePlan:
    """Resolve names through the registries and compose a plan. Fails fast
    with a ValueError when a power-of-two-only schedule meets a pod count
    that is not one."""
    sched = (schedules_lib.get(schedule) if isinstance(schedule, str)
             else schedule)
    comp = (compression_lib.get(compression) if isinstance(compression, str)
            else compression)
    if sched.pow2_only and n_total > 1 and n_total & (n_total - 1) != 0:
        raise ValueError(
            f"schedule '{sched.name}' needs a power-of-two participant "
            f"count, got {n_total} — use ring/psum/round_robin instead")
    if group is not None and sched.name not in GROUP_SCHEDULES:
        raise NotImplementedError(
            f"schedule '{sched.name}' over a pod axis of "
            f"{dist.get_world_size(group)} processes: only "
            f"{GROUP_SCHEDULES} run over a process group (ROADMAP.md)")
    return ExchangePlan(schedule=sched, compression=comp, overlap=overlap,
                        n_total=n_total, topology=topology, group=group)

"""ExchangePlan: schedule × packing × compression × overlap as ONE object
(the port of ``repro/comm/plan.py``).

The plan is what the multi-pod step consumes for the cross-pod exchange.
In the port the P pods are the rows of one tensor on one device, so the
plan's collective is a sum over rows (``Schedule.allreduce``):

 * ``reduce_mean_flat(delta, ef)`` — the packed exchange of
   ``core.elastic``: ``(P, n)`` rows -> their mean ``(n,)``, through the
   compression (each pod row encoded with its own error feedback, every
   payload leaf summed over the rows, divided by the pod count, decoded);
 * ``exchange(tree)`` — a pytree whose leaves carry a leading pod dim ->
   the cross-pod mean pytree, packed into one buffer per pod (§5.2);
 * ``cost_s`` / ``visible_cost_s`` — the same exchange under the α–β
   model; ``overlap`` (§6.1.3) decides whether compute hides it.

The reference's ``axis_name`` (the mesh axis of its collective) has no
counterpart: every pod row is local.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.comm import schedules as schedules_lib
from repro_torch.core import compression as compression_lib
from repro_torch.core import costmodel
from repro_torch.core import packing as packing_lib
from repro_torch.models.common import tree_leaves_with_path, tree_unflatten


@dataclasses.dataclass(frozen=True)
class ExchangePlan:
    """A fully-composed cross-pod exchange among ``n_total`` pods."""

    schedule: schedules_lib.Schedule
    compression: compression_lib.Compression
    overlap: bool = True
    n_total: int = 1
    # two-level fabric for pricing only; None prices the flat model
    topology: costmodel.Topology | None = None

    def allreduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``(P, ...)`` pod rows through the plan's schedule."""
        return self.schedule.allreduce(x)

    def reduce_mean_flat(self, delta: torch.Tensor, ef=None):
        """Cross-pod mean of packed rows: ``(P, n)`` -> ``((n,), new_ef)``.
        ``ef`` is the error-feedback state (required when compression is
        on, shaped like ``delta``)."""
        n = float(max(self.n_total, 1))
        # a 0-d divisor on the rows' device (CUDA's division by a Python
        # scalar multiplies by its reciprocal); a fill, not a host copy
        div = torch.full((), n, dtype=torch.float32, device=delta.device)
        if self.compression.name != "none":
            if ef is None:
                raise ValueError("compression requires error-feedback state")
            encoded = [self.compression.encode(d, e)
                       for d, e in zip(delta, ef)]
            ef_new = torch.stack([e for _, e in encoded])
            payload = [self.allreduce_sum(torch.stack(leaf))
                       for leaf in zip(*(p for p, _ in encoded))]
            payload = [x.to(torch.float32).div_(div) for x in payload]
            return self.compression.decode_mean(payload), ef_new
        # in place on the fresh sum: one (n,) buffer at full width
        return self.allreduce_sum(delta).div_(div), ef

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


def make_plan(schedule: str = "psum", compression: str = "none",
              overlap: bool = True, n_total: int = 1,
              topology: costmodel.Topology | None = None) -> ExchangePlan:
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
    return ExchangePlan(schedule=sched, compression=comp, overlap=overlap,
                        n_total=n_total, topology=topology)

"""The exchange-schedule registry: each schedule's message rounds, its α–β
cost and its all-reduce over pod rows (the port of
``repro/comm/schedules.py``).

The PS runtime executes ``Schedule.rounds`` over its mailbox tensor, and
``cost`` prices the same exchange. ``Schedule.allreduce`` is the
counterpart of the reference's ``shard_map`` collectives for the multi-pod
step, whose pods are the rows of one tensor on one device: it sums a
``(P, ...)`` tensor over its rows. ``psum`` is one reduction over dim 0, as
``lax.psum`` is in the reference; every other schedule runs its message
rounds over the rows (``comm.rounds.execute_rounds``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core import costmodel
from repro_torch.comm.rounds import (bytes_from_rounds, butterfly_rounds,
                                     execute_rounds, hierarchical_rounds,
                                     inner_size, psum_rounds, ring_rounds,
                                     round_robin_rounds, t_rounds,
                                     tree_rounds)

_NET = costmodel.PCIE3_X16


def t_hierarchical_allreduce(n: float, p: int, net: costmodel.Network
                             ) -> float:
    """Ring over the inner group + butterfly across groups (paper §6.2)."""
    m = inner_size(p)
    return (costmodel.t_ring_allreduce(n, m, net)
            + costmodel.t_butterfly_allreduce(n, max(p // m, 1), net))


@dataclasses.dataclass(frozen=True)
class Schedule:
    """One exchange schedule: its message rounds and its α–β cost.

    ``cost_fn(n_bytes, p, net)`` — seconds for one full exchange of an
    n-byte buffer among p participants; ``rounds_fn(p, n_bytes, net)`` —
    the same exchange as explicit message rounds."""

    name: str
    cost_fn: Callable
    rounds_fn: Callable
    pow2_only: bool = False
    native: bool = False        # allreduce is one reduction over dim 0
    doc: str = ""

    def allreduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum a ``(P, ...)`` tensor over its P pod rows; returns the sum,
        shaped ``x.shape[1:]``, in x's dtype (int8 signs stay int8)."""
        p = x.shape[0]
        if self.native or p == 1:
            return x.sum(0, dtype=x.dtype)
        flat = x.reshape(p, -1)
        m = flat.shape[1]
        # chunked schedules need rows that P divides; row P is the master
        # endpoint round_robin gathers into
        mailbox = torch.zeros((p + 1, m + (-m) % p), dtype=x.dtype,
                              device=x.device)
        mailbox[:p, :m] = flat
        execute_rounds(mailbox, m, self.rounds(p, m * x.element_size()))
        return mailbox[0, :m].reshape(x.shape[1:])

    def cost(self, n_bytes: float, p: int,
             net: costmodel.Network = _NET) -> float:
        """α–β time of one full exchange (0 for a single participant)."""
        if p <= 1:
            return 0.0
        return self.cost_fn(n_bytes, p, net)

    def rounds(self, p: int, n_bytes: float = 0.0,
               net: costmodel.Network = _NET,
               topology: costmodel.Topology | None = None) -> list:
        """The exchange as explicit message rounds (empty for p ≤ 1). A
        ``topology`` groups hierarchical by host and lifts its flat
        power-of-two gate (hierarchical_rounds checks the group count)."""
        if p <= 1:
            return []
        if self.pow2_only and p & (p - 1) != 0 and not (
                self.name == "hierarchical" and topology is not None):
            raise ValueError(
                f"schedule '{self.name}' needs a power-of-two participant "
                f"count, got {p} — its round structure would address "
                f"nonexistent ranks (use ring/round_robin instead)")
        if topology is not None:
            return self.rounds_fn(p, n_bytes, net, topology=topology)
        return self.rounds_fn(p, n_bytes, net)

    def cost_from_rounds(self, n_bytes: float, p: int,
                         net: costmodel.Network = _NET) -> float:
        """Per-round α–β pricing: each round costs α + max_frac·n·β (its
        messages fly concurrently); rounds serialize."""
        return sum(net.alpha + max(m.frac for m in rnd) * n_bytes * net.beta
                   for rnd in self.rounds(p, n_bytes, net))

    def bytes_from_rounds(self, n_bytes: float, p: int,
                          net: costmodel.Network = _NET) -> float:
        """Total payload bytes the schedule's messages move for one
        exchange of an n-byte buffer (what the p2p per-link byte counters
        sum to)."""
        return bytes_from_rounds(self.rounds(p, n_bytes, net), n_bytes)

    def cost_topo(self, n_bytes: float, p: int,
                  topology: costmodel.Topology | None = None) -> float:
        """α–β time on a two-level fabric: the schedule's own rounds priced
        message by message; a missing or uniform topology is ``cost`` on
        its intra network."""
        if topology is None or topology.uniform:
            return self.cost(n_bytes, p,
                             topology.intra if topology is not None else _NET)
        if p <= 1:
            return 0.0
        return t_rounds(
            self.rounds(p, n_bytes, topology.intra, topology=topology),
            n_bytes, net=topology.intra, topology=topology)


SCHEDULES: dict[str, Schedule] = {}


def register(schedule: Schedule) -> Schedule:
    SCHEDULES[schedule.name] = schedule
    return schedule


def get(name: str) -> Schedule:
    try:
        return SCHEDULES[name]
    except KeyError:
        raise ValueError(
            f"unknown schedule '{name}', have {sorted(SCHEDULES)}"
        ) from None


def names() -> tuple:
    """Registered schedule names, in registration order."""
    return tuple(SCHEDULES)


register(Schedule(
    "psum", costmodel.t_allreduce_best, psum_rounds, native=True,
    doc="a tuned library's all-reduce; priced as min(butterfly, ring)."))
register(Schedule(
    "tree", costmodel.t_tree_allreduce, tree_rounds, pow2_only=True,
    doc="reduce-to-root + broadcast, 2·⌈log2 P⌉ rounds (paper §5.1)."))
register(Schedule(
    "butterfly", costmodel.t_butterfly_allreduce, butterfly_rounds,
    pow2_only=True,
    doc="recursive doubling, ⌈log2 P⌉ rounds — latency-optimal."))
register(Schedule(
    "ring", costmodel.t_ring_allreduce, ring_rounds,
    doc="reduce-scatter + all-gather, 2(P−1) steps of n/P bytes — "
        "bandwidth-optimal."))
register(Schedule(
    "round_robin", costmodel.t_round_robin_allreduce, round_robin_rounds,
    doc="Original EASGD's serialized master↔worker exchange, Θ(P) — the "
        "paper's baseline."))
register(Schedule(
    "hierarchical", t_hierarchical_allreduce, hierarchical_rounds,
    pow2_only=True,
    doc="ring within groups of 2^⌈log2(P)/2⌉ ranks, butterfly across "
        "groups (paper §6.2)."))


def choose(n_bytes: float, p: int, net: costmodel.Network = _NET,
           topology: costmodel.Topology | None = None,
           profile: costmodel.LinkProfile | None = None) -> str:
    """α–β-driven choice: latency-bound small buffers → butterfly,
    bandwidth-bound → ring; butterfly only for a power-of-two p. On a
    non-uniform ``topology`` (or a measured ``profile``'s, when no
    topology is given) hierarchical joins the candidates and each is
    priced link by link; candidate order breaks ties."""
    if profile is not None and topology is None:
        topology = profile.topology
    if p <= 1:
        return "psum"
    if topology is not None and not topology.uniform:
        cands = ["butterfly"] if p & (p - 1) == 0 else []
        cands.append("ring")
        try:
            get("hierarchical").rounds(p, n_bytes, topology.intra,
                                       topology=topology)
        except ValueError:
            pass
        else:
            cands.append("hierarchical")
        return min(cands,
                   key=lambda nm: get(nm).cost_topo(n_bytes, p, topology))
    if topology is not None:
        net = topology.intra
    if p & (p - 1) == 0 and get("butterfly").cost(n_bytes, p, net) <= \
            get("ring").cost(n_bytes, p, net):
        return "butterfly"
    return "ring"

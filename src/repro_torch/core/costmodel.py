"""α–β communication model (paper Table 2) — the part of
``repro/core/costmodel.py`` that the exchange schedules price with.

A message of n bytes costs α + n·β seconds. The reference's TPU link and
chip constants and its roofline are not carried over: nothing here
describes the card. ``PCIE3_X16`` is the PS runtime's own default network
(``repro/ps/runtime.py:60``) and is the default wherever a schedule is
priced without an explicit network.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Network:
    name: str
    alpha: float   # seconds per message
    beta: float    # seconds per byte


# the PS runtime's default α–β network: it only prices psum's
# butterfly-vs-ring choice for the sync rounds
PCIE3_X16 = Network("PCIe3x16", 5e-6, 1 / 12e9)

# the PS runtime's EMULATED wire (PSConfig.emulate_net): Ethernet-class
# latency with bandwidth scaled so the full-model message time vs
# per-minibatch compute matches the paper's AlexNet-over-Ethernet regime
PS_WIRE = Network("emulated PS wire (Ethernet-class, model-scaled)",
                  50e-6, 1.0 / 9e6)


@dataclasses.dataclass(frozen=True)
class Topology:
    """A two-level fabric: ``hosts`` nodes of ``slots`` workers each, worker
    i on host ``i // slots``. Links within a host pay ``intra``; links that
    cross hosts, or touch the master endpoint, pay ``cross``."""

    hosts: int
    slots: int
    intra: Network = PS_WIRE
    cross: Network = PS_WIRE

    @property
    def p(self) -> int:
        return self.hosts * self.slots

    def host_of(self, wid: int) -> int:
        """Host of a worker; the master (negative wid) is its own host."""
        return -1 if wid < 0 else wid // self.slots

    def link(self, i: int, j: int) -> Network:
        """The network class the (i, j) link rides."""
        if self.hosts <= 1:
            return self.intra
        return (self.intra if self.host_of(i) == self.host_of(j)
                else self.cross)

    @property
    def uniform(self) -> bool:
        """True when every link prices identically."""
        return self.hosts <= 1 or self.intra == self.cross


def t_msg(n: float, net: Network) -> float:
    """Point-to-point message cost: α + nβ."""
    return net.alpha + n * net.beta


def t_round_robin_allreduce(n: float, p: int, net: Network) -> float:
    """Original EASGD's serialized gather + broadcast: 2·P messages."""
    return 2 * p * t_msg(n, net)


def t_tree_allreduce(n: float, p: int, net: Network) -> float:
    """Tree reduce + broadcast: 2·⌈log2 P⌉ rounds of full-size messages."""
    if p <= 1:
        return 0.0
    return 2 * math.ceil(math.log2(p)) * t_msg(n, net)


def t_butterfly_allreduce(n: float, p: int, net: Network) -> float:
    """Recursive doubling: ⌈log2 P⌉ rounds of full-size messages."""
    if p <= 1:
        return 0.0
    return math.ceil(math.log2(p)) * t_msg(n, net)


def t_ring_allreduce(n: float, p: int, net: Network) -> float:
    """Bandwidth-optimal ring: 2(P−1) steps of n/P bytes."""
    if p <= 1:
        return 0.0
    return 2 * (p - 1) * t_msg(n / p, net)


def t_allreduce_best(n: float, p: int, net: Network) -> float:
    """What a tuned library picks: min(butterfly, ring)."""
    return min(t_butterfly_allreduce(n, p, net), t_ring_allreduce(n, p, net))

"""α–β communication model (paper Table 2) — the part of
``repro/core/costmodel.py`` that the exchange schedules price with.

A message of n bytes costs α + n·β seconds. The reference's chip
constants and its roofline are not carried over: nothing here describes
the card. ``PCIE3_X16`` is the PS runtime's own default network
(``repro/ps/runtime.py:60``) and is the default wherever a schedule is
priced without an explicit network. The two-level fabric (``Topology``,
``LinkProfile``, ``emulated_topology``) prices the PS runtime's per-link
pacing and the schedule choice under ``PSConfig.topology``.
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

# the network on which the reference prices its packed multi-pod exchange
# (its cross-pod link, ``repro/core/costmodel.py`` TPU_DCI): the multi-pod
# step's "auto" schedule is chosen on it so that the port resolves the
# reference's schedule, and so sums the pod rows in the same order. It
# describes no link of the card (the pods are rows of one tensor there)
POD_EXCHANGE_NET = Network("the reference's pod-row exchange network",
                            10.0e-6, 1.0 / 12.5e9)


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

    def to_wire(self) -> dict:
        """JSON-safe form (WELCOME ships it to the workers)."""
        return {"hosts": self.hosts, "slots": self.slots,
                "intra": [self.intra.name, self.intra.alpha,
                          self.intra.beta],
                "cross": [self.cross.name, self.cross.alpha,
                          self.cross.beta]}

    @staticmethod
    def from_wire(d: dict) -> "Topology":
        return Topology(hosts=int(d["hosts"]), slots=int(d["slots"]),
                        intra=Network(*d["intra"]),
                        cross=Network(*d["cross"]))


@dataclasses.dataclass(frozen=True)
class LinkProfile:
    """Per-link-class α–β as measured on a live mesh
    (``ps.measured_link_profile``), in the shape the chooser prices.
    ``source`` names where the numbers came from ('analytic',
    'measured:thread', 'measured:tcp'); ``detail`` carries the raw
    observations."""

    topology: Topology
    source: str = "analytic"
    detail: dict = dataclasses.field(default_factory=dict)

    def to_wire(self) -> dict:
        return {"topology": self.topology.to_wire(), "source": self.source,
                "detail": dict(self.detail)}

    @staticmethod
    def from_wire(d: dict) -> "LinkProfile":
        return LinkProfile(topology=Topology.from_wire(d["topology"]),
                           source=str(d.get("source", "analytic")),
                           detail=dict(d.get("detail", {})))


def emulated_topology(hosts: int, slots: int, intra: Network = PS_WIRE,
                      cross_alpha_x: float = 20.0,
                      cross_beta_x: float = 4.0) -> Topology:
    """The emulated two-level fabric: intra-host links are ``intra``;
    cross-host links stretch its α by ``cross_alpha_x`` and β by
    ``cross_beta_x``. Unit multipliers give ``cross = intra`` (the same
    object): a uniform topology."""
    if hosts < 1 or slots < 1:
        raise ValueError(f"topology needs hosts, slots >= 1, "
                         f"got {hosts}x{slots}")
    if cross_alpha_x == 1.0 and cross_beta_x == 1.0:
        cross = intra
    else:
        cross = Network(
            f"{intra.name} [cross-host {cross_alpha_x:g}xA "
            f"{cross_beta_x:g}xB]",
            intra.alpha * cross_alpha_x, intra.beta * cross_beta_x)
    return Topology(hosts=hosts, slots=slots, intra=intra, cross=cross)


def t_hierarchical_two_level(n: float, topo: Topology) -> float:
    """Closed-form two-level hierarchical all-reduce on ``topo``: a ring
    inside each host (intra links) plus a butterfly across hosts (cross
    links) — the analytic cross-check of the rounds-level price."""
    inner = t_ring_allreduce(n, topo.slots, topo.intra)
    outer = t_butterfly_allreduce(n, topo.hosts, topo.cross)
    return inner + outer


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

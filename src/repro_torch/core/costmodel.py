"""α–β communication model (paper Table 2), the roofline, and the work
of each hand-written kernel (the port of ``repro/core/costmodel.py``).

A message of n bytes costs α + n·β seconds. ``PCIE3_X16`` is the PS
runtime's own default network (``repro/ps/runtime.py:60``) and is the
default wherever a schedule is priced without an explicit network. The
two-level fabric (``Topology``, ``LinkProfile``, ``emulated_topology``)
prices the PS runtime's per-link pacing and the schedule choice under
``PSConfig.topology``.

The roofline prices a step's FLOPs, bytes and collective bytes on a
``Chip``: ``H100_SXM`` from NVIDIA's H100 SXM data sheet, and the
paper's 2017 nodes (``KNL_7250``, ``K80_HALF``) for its own tables. The
``*_work`` functions give each kernel's work on its shapes as ``(bytes,
operations)``: each input read once, each output written once, and the
products the run's masks leave. ``chip_smoke.py`` bounds every kernel
timing with them, and ``launch.opcount`` counts a kernel region's work
with them, whichever path (kernel or plain version) runs it.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Network:
    name: str
    alpha: float   # seconds per message
    beta: float    # seconds per byte


# Paper Table 2 (β given per 4-byte word there; stored per byte here)
MELLANOX_FDR = Network("Mellanox 56Gb/s FDR IB", 0.7e-6, 0.2e-9 / 4)
INTEL_QDR = Network("Intel 40Gb/s QDR IB", 1.2e-6, 0.3e-9 / 4)
INTEL_10GBE = Network("Intel 10GbE NE020", 7.2e-6, 0.9e-9 / 4)

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


def t_round_robin(n: float, p: int, net: Network) -> float:
    """Original EASGD's schedule: the master exchanges with each worker in
    rank order, P sequential messages, Θ(P)."""
    return p * t_msg(n, net)


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


def t_per_layer(layer_bytes: list, p: int, net: Network,
                schedule=t_allreduce_best) -> float:
    """Per-layer communication (paper Fig. 10 'unpacked'): one collective
    per tensor."""
    return sum(schedule(n, p, net) for n in layer_bytes)


def t_packed(layer_bytes: list, p: int, net: Network,
             schedule=t_allreduce_best) -> float:
    """Packed single-buffer communication (paper Fig. 10 'packed')."""
    return schedule(sum(layer_bytes), p, net)


# ---------------------------------------------------------------------------
# chips and the roofline
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Chip:
    name: str
    peak_flops: float      # FLOP/s (dense bf16 tensor-core rate)
    hbm_bandwidth: float   # bytes/s
    hbm_bytes: float       # capacity
    link_bandwidth: float  # bytes/s per direction of the chip's links


# NVIDIA H100 SXM5 data sheet: 989 TFLOP/s dense bf16, 3.35 TB/s HBM3,
# 80 GB; NVLink 4 at 900 GB/s a GPU in both directions together, 450 GB/s
# each way (chip_smoke.PEAKS' "H100" row holds the same rates)
H100_SXM = Chip("NVIDIA H100 SXM", 989e12, 3.35e12, 80 * 1024**3, 450e9)

# the paper's 2017 nodes, for reproducing its own tables
KNL_7250 = Chip("Intel KNL 7250 (paper)", 6e12 / 2, 475e9, 384 * 1024**3,
                56e9 / 8)
K80_HALF = Chip("NVIDIA K80, half a board (paper)", 4.37e12 / 2, 240e9,
                12 * 1024**3, 16e9)


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        """Lower bound on the step time if the three resources overlap."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def serial_s(self) -> float:
        """Upper bound: no overlap at all."""
        return self.compute_s + self.memory_s + self.collective_s


def roofline(hlo_flops: float, hlo_bytes: float, collective_bytes: float,
             chips: int, chip: Chip = H100_SXM) -> RooflineTerms:
    """The three terms: FLOPs over the chips' peak, bytes over their
    memory rate, collective bytes over their link rate. The arguments
    are whole-program totals (all chips): multiply per-chip counts by
    ``chips`` first."""
    return RooflineTerms(
        compute_s=hlo_flops / (chips * chip.peak_flops),
        memory_s=hlo_bytes / (chips * chip.hbm_bandwidth),
        collective_s=collective_bytes / (chips * chip.link_bandwidth))


def model_flops_train(n_params_active: float, n_tokens: float) -> float:
    """MODEL_FLOPS = 6·N·D (forward 2ND + backward 4ND), N active params."""
    return 6.0 * n_params_active * n_tokens


def model_flops_infer(n_params_active: float, n_tokens: float) -> float:
    """Forward only: 2·N·D."""
    return 2.0 * n_params_active * n_tokens


# ---------------------------------------------------------------------------
# the kernels' work: (bytes, operations) on their shapes
# ---------------------------------------------------------------------------

def bound_ms(n_bytes: float, n_ops: float, bw: float, rate: float) -> tuple:
    """``(ms, "bytes" | "operations")``: the larger of the bytes over the
    memory rate and the operations over the compute rate."""
    t_bytes, t_ops = n_bytes / bw, n_ops / rate
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def attn_pairs(S: int, causal: bool, window: int) -> int:
    """(query, key) pairs the masks leave in one head of S positions: the
    work this run's masks need, not the S² a dense product would do.
    Query q sees keys ``[max(0, q − window + 1), q + 1)`` (causal) or
    ``[max(0, q − window + 1), S)``; window 0 is none."""
    if causal:
        if not window or S <= window:
            return S * (S + 1) // 2
        return window * (window + 1) // 2 + (S - window) * window
    cut = S - window if window and S > window else 0
    return S * S - cut * (cut + 1) // 2


def attention_fwd_work(B, S, H, KVH, D, Dv, causal, window,
                       itemsize) -> tuple:
    """``flash_attention_fwd``: s = q·kᵀ (over D) and p·v (over Dv) on the
    unmasked pairs, reading q, k, v and writing out and the f32 lse."""
    pairs = B * H * attn_pairs(S, causal, window)
    q_b, o_b = B * S * H * D * itemsize, B * S * H * Dv * itemsize
    k_b, v_b = B * S * KVH * D * itemsize, B * S * KVH * Dv * itemsize
    return (q_b + k_b + v_b + o_b + B * S * H * 4, 2 * pairs * (D + Dv))


def attention_bwd_work(B, S, H, KVH, D, Dv, causal, window,
                       itemsize) -> tuple:
    """``flash_attention_bwd``: s and dq, dk over D, dp and dv over Dv (the
    flash backward's five products), reading q, k, v, out, dout and lse
    and writing dq, dk, dv."""
    pairs = B * H * attn_pairs(S, causal, window)
    q_b, o_b = B * S * H * D * itemsize, B * S * H * Dv * itemsize
    k_b, v_b = B * S * KVH * D * itemsize, B * S * KVH * Dv * itemsize
    return (2 * (q_b + k_b + v_b + o_b) + B * S * H * 4,
            2 * pairs * (3 * D + 2 * Dv))


def ce_fwd_work(T, d, V, itemsize) -> tuple:
    """``fused_ce_fwd``: the (T, d) × (d, V) logits, reading h, w and the
    int64 targets and writing loss, lse (f32) and pred (int64)."""
    return (T * d * itemsize + d * V * itemsize + T * 8 + T * (4 + 4 + 8),
            2.0 * T * d * V)


def ce_bwd_work(T, d, V, itemsize) -> tuple:
    """``fused_ce_bwd``: the logits again, dh = dlogits·wᵀ and dw =
    hᵀ·dlogits, reading h, w, targets, lse and g, writing dh and dw."""
    return (2 * (T * d * itemsize + d * V * itemsize) + T * (8 + 4 + 4),
            3 * 2.0 * T * d * V)


def _ssd_sizes(B, H, S, P, N, L) -> tuple:
    nc, pairs = S // L, L * (L + 1) // 2
    return (nc * pairs, 4 * B * H * S, 4 * B * H * S * P, 4 * B * S * N)


def ssd_fwd_work(B, H, S, P, N, L) -> tuple:
    """``ssd_intra_fwd`` (f32): over the L (L + 1) / 2 causal pairs of each
    chunk, G = C·Bᵀ once per (batch row, chunk) and M·X per head, 2
    operations a product term; reads a, x, b, c and writes y."""
    cp, a, x, bc = _ssd_sizes(B, H, S, P, N, L)
    return a + 2 * x + 2 * bc, 2 * B * cp * (N + H * P)


def ssd_bwd_work(B, H, S, P, N, L) -> tuple:
    """``ssd_intra_bwd``: G again, dC, dB and, per head, dX and dM; reads
    a, x, b, c, dy and writes dx, db, dc, da."""
    cp, a, x, bc = _ssd_sizes(B, H, S, P, N, L)
    return 2 * a + 3 * x + 4 * bc, 2 * B * cp * (3 * N + 2 * H * P)


def elastic_update_work(p: int, n: int, sizes) -> tuple:
    """``fused_elastic_update`` on P pod rows of n elements whose (W, V, G,
    C, M) are stored in ``sizes`` bytes an element: W, V and C read and
    written, G and M read; per element 7 operations for each pod (V' 3,
    W' 4) and 3 for C'."""
    w, v, g, c, m = sizes
    return (p * n * (2 * w + 2 * v + g) + n * (2 * c + m), (7 * p + 3) * n)


def sync_easgd_work(n: int) -> tuple:
    """``fused_sync_easgd_update`` (f64): W and C read and written, the
    gradient and the worker row read; 9 operations an element (W' 5, C'
    4)."""
    return 6 * 8 * n, 9 * n


def sync_easgd_solo_work(n: int) -> tuple:
    """``fused_sync_easgd_update`` with no center to move (one worker): W
    read and written, the gradient and the row read; 5 operations."""
    return 4 * 8 * n, 5 * n


def sync_sgd_work(n: int) -> tuple:
    """``fused_sync_sgd_update`` (f64): center and velocity read and
    written, the summed row read; 5 operations an element."""
    return 5 * 8 * n, 5 * n

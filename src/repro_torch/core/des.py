"""Discrete-event schedule models for the paper's system experiments (the
port of ``repro/core/des.py``).

Pure timing, no training: from hardware constants (α–β links, compute
rates) and a schedule (round-robin, tree, partitioning, overlap), per-part
time breakdowns for Table 3 / Fig 11, Fig 12 and Table 4. Float arithmetic
over ``core.costmodel`` and the ``comm.schedules`` registry, in the
reference's order, so every function returns the reference's floats.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.comm import schedules as comm_schedules
from repro_torch.core import costmodel


@dataclasses.dataclass(frozen=True)
class GpuBox:
    """The paper's 4-GPU node (§10.4), calibrated to Table 3's measured
    part-times (the paper's constants, not the H100's):
      * t_fwd_bwd = 6 ms/iter (Table 3: 6 s / 1000 iters),
      * unpinned per-iteration CPU↔GPU exchange ≈ 3.47 ms/message,
      * pinned/batched tree rounds ≈ 0.57 ms (Sync EASGD1),
      * GPU↔GPU switch rounds ≈ 0.33 ms (Sync EASGD2).
    """
    n_gpus: int = 4
    # Original EASGD's per-iteration master↔worker path (synchronous copies)
    pcie_unpinned: costmodel.Network = costmodel.Network(
        "PCIe h2d unpinned", 3.3e-3, 1 / 10e9)
    # Sync EASGD1: CPU-rooted tree, pinned transfers
    pcie_h2d: costmodel.Network = costmodel.Network("PCIe h2d", 0.4e-3,
                                                    1 / 10e9)
    # Sync EASGD2/3: GPU-GPU over the 96-lane PCIe switch
    pcie_p2p: costmodel.Network = costmodel.Network("PCIe p2p", 0.2e-3,
                                                    1 / 24e9)
    t_fwd_bwd: float = 6e-3          # per iteration (Table 3)
    t_gpu_update: float = 0.4e-3
    t_cpu_update: float = 0.7e-3
    weight_bytes: float = 1.7e6      # LeNet
    data_bytes: float = 64 * 28 * 28 * 4.0


GPU_BOX = GpuBox()


@dataclasses.dataclass
class Breakdown:
    iters: int
    parts: dict                      # name -> seconds

    @property
    def total_s(self) -> float:
        return sum(self.parts.values())

    @property
    def comm_ratio(self) -> float:
        comm = sum(v for k, v in self.parts.items() if "comm" in k)
        return comm / max(self.total_s, 1e-12)


def breakdown_original_easgd(box: GpuBox, iters: int,
                             overlap: bool = True) -> Breakdown:
    """Alg. 1: round-robin; ONE worker computes per iteration; the
    master↔worker weight exchange is serialized. ``overlap=True`` is the
    paper's Original EASGD row, ``False`` Original EASGD*."""
    W, net = box.weight_bytes, box.pcie_unpinned
    per_iter_comm = 2 * costmodel.t_msg(W, net)          # W̄ down, W_j up
    per_iter_fb = box.t_fwd_bwd                          # one GPU working
    t_data = costmodel.t_msg(box.data_bytes, box.pcie_h2d)
    if overlap:
        fb_visible = max(per_iter_fb - per_iter_comm, 0.0)
    else:
        fb_visible = per_iter_fb
    parts = {
        "cpu_gpu_data_comm": iters * t_data,
        "cpu_gpu_para_comm": iters * per_iter_comm,
        "fwd_bwd": iters * fb_visible,
        "gpu_update": iters * box.t_gpu_update,
        "cpu_update": iters * box.t_cpu_update,
    }
    return Breakdown(iters, parts)


def breakdown_sync_easgd(box: GpuBox, iters: int, *, weights_on: str,
                         overlap: bool,
                         schedule: str = "tree") -> Breakdown:
    """Sync EASGD1 (weights on CPU), 2 (weights on GPU), 3 (+overlap). All
    GPUs compute every iteration; the exchange is priced through the
    ``comm`` registry (default: the paper's tree reduction)."""
    G = box.n_gpus
    W = box.weight_bytes
    net = box.pcie_h2d if weights_on == "cpu" else box.pcie_p2p
    t_comm = comm_schedules.get(schedule).cost(W, G, net)
    t_data = costmodel.t_msg(box.data_bytes, box.pcie_h2d)
    t_fb = box.t_fwd_bwd
    key = "cpu_gpu_para_comm" if weights_on == "cpu" else "gpu_gpu_para_comm"
    if overlap:
        # §6.1.3: the exchange overlaps fwd/bwd only partially on the shared
        # PCIe switch (Table 3: sync3 still shows 10 % gpu-gpu comm)
        visible_comm = max(t_comm * 0.45, t_comm - t_fb)
        fb = t_fb
    else:
        visible_comm = t_comm
        fb = t_fb
    parts = {
        "cpu_gpu_data_comm": iters * t_data,
        key: iters * visible_comm,
        "fwd_bwd": iters * fb,
        "gpu_update": iters * box.t_gpu_update,
        "cpu_update": iters * (box.t_cpu_update if weights_on == "cpu"
                               else box.t_gpu_update),
    }
    return Breakdown(iters, parts)


def partition_sweep_time(n_parts: int, *, t_compute_1: float,
                         weight_bytes: float, fast_mem_bytes: float,
                         data_bytes: float,
                         net: costmodel.Network,
                         saturation: float = 6.0,
                         floor: float = 0.30,
                         schedule: str = "tree") -> float:
    """Fig 12: time with the chip split into ``n_parts`` NUMA groups,
    t(P) = t1·(floor + (1−floor)·e^{−(P−1)/saturation}), three times slower
    once n_parts copies of (weights + data) no longer fit fast memory, plus
    the exchange."""
    fits = n_parts * (weight_bytes + data_bytes) <= fast_mem_bytes
    speed = 1.0 if fits else 3.0
    decay = math.exp(-(n_parts - 1) / saturation)
    t_compute = speed * t_compute_1 * (floor + (1 - floor) * decay)
    t_comm = comm_schedules.get(schedule).cost(weight_bytes, n_parts, net)
    return t_compute + t_comm


def weak_scaling_efficiency(n_nodes: int, *, t_compute: float,
                            weight_bytes: float,
                            net: costmodel.Network,
                            jitter_sigma: float = 0.0,
                            overlap: bool = True,
                            schedule: str = "psum",
                            topology: costmodel.Topology | None = None
                            ) -> float:
    """Table 4: per-step time = slowest node (lognormal jitter σ: the
    expected max over N grows ≈ σ·√(2 ln N)) + the packed all-reduce,
    priced per link class on a non-uniform ``topology``."""
    if topology is not None and not topology.uniform:
        t_comm = comm_schedules.get(schedule).cost_topo(
            weight_bytes, n_nodes, topology)
    else:
        t_comm = comm_schedules.get(schedule).cost(weight_bytes, n_nodes, net)
    straggle = jitter_sigma * math.sqrt(2 * math.log(n_nodes)) \
        if n_nodes > 1 else 0.0
    tn = t_compute * (1 + straggle) + t_comm * (0.0 if overlap else 1.0)
    if overlap:
        tn = max(tn, t_comm)
    return t_compute / tn


def jitter_from_two_node_eff(eff2: float) -> float:
    """Invert the straggler model at N=2: eff(2)=1/(1+σ√(2 ln 2))."""
    return (1.0 / eff2 - 1.0) / math.sqrt(2 * math.log(2))

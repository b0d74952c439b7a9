"""Event-driven parameter-server engine: the paper's nine algorithms with
real convergence and modelled wall time (the port of
``repro/core/async_engine.py``).

The optimizer math runs for real, through the same in-place functions of
``core.easgd_flat`` that the PS runtime executes, on f64 tensors on the
engine's device; time advances on a discrete-event clock with an α–β
communication model and per-worker compute times. So the same event order
gives the runtime's iterates bit for bit (``ps.run_vs_des``, the DES↔real
cross-check).

The clock is the reference's draw for draw: compute jitter comes from
``np.random.RandomState(sim.seed)`` in the same order, the exchange is
priced by the port's ``comm.schedules`` registry, and every time is a
Python float — so the event order, the breakdown and the history equal the
reference's, with jitter on too.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.comm import schedules as comm_schedules
from repro_torch.core import costmodel, easgd_flat
from repro_torch.core.easgd import EASGDConfig
from repro_torch.utils.device import resolve_device

ALGORITHMS = (
    "original_easgd",
    "async_sgd", "async_easgd",
    "async_msgd", "async_measgd",
    "hogwild_sgd", "hogwild_easgd",
    "sync_sgd", "sync_easgd",
)


@dataclasses.dataclass
class SimConfig:
    n_workers: int = 4
    # communication (defaults: PCIe-switch multi-GPU box, paper §10.4)
    net: costmodel.Network = costmodel.PCIE3_X16
    schedule: str = "tree"           # the sync exchange's comm schedule
    t_compute: float = 1e-3          # fwd/bwd per minibatch, seconds
    compute_jitter: float = 0.10     # lognormal sigma (stragglers)
    t_update_per_byte: float = 1 / 100e9   # elementwise update bandwidth
    eval_every_iters: int = 100
    seed: int = 0
    # two-level fabric: when set and non-uniform, sync exchanges are priced
    # per link class (``Schedule.cost_topo``); None keeps the flat ``net``
    topology: Optional[costmodel.Topology] = None


@dataclasses.dataclass
class RunResult:
    algorithm: str
    history: list                    # [(sim_time_s, total_iters, metric)]
    total_time_s: float
    total_iters: int
    breakdown: dict                  # category -> seconds (Table 3 analogue)
    final_metric: float
    center: Optional[torch.Tensor] = None    # final W̄
    workers: Optional[torch.Tensor] = None   # final (P, n) worker weights


def mean_rows(rows) -> torch.Tensor:
    """``np.mean(rows, axis=0)`` in numpy's order: the rows added in rank
    order, then one division by P through a 0-d tensor (CUDA's ``div`` by
    a Python scalar multiplies by the reciprocal, which is not the same
    bits)."""
    acc = rows[0].clone()
    for r in rows[1:]:
        acc.add_(r)
    return acc / torch.tensor(float(len(rows)), dtype=acc.dtype,
                              device=acc.device)


class PSEngine:
    """grad_fn(w_row, step, worker) -> grad_row; eval_fn(w_row) -> metric.

    The iterates live on ``w0``'s device (the problem's); a numpy ``w0``
    goes to the card."""

    def __init__(self, grad_fn: Callable, eval_fn: Callable, w0,
                 easgd: EASGDConfig, sim: SimConfig):
        dev = (w0.device if isinstance(w0, torch.Tensor)
               else resolve_device(None))
        self.grad_fn = grad_fn
        self.eval_fn = eval_fn
        self.w0 = torch.as_tensor(w0).to(dev, torch.float64)
        self.cfg = easgd
        self.sim = sim
        self.nbytes = self.w0.numel() * 8

    # -- timing helpers -------------------------------------------------------
    def _t_compute(self, rng) -> float:
        j = self.sim.compute_jitter
        return self.sim.t_compute * float(rng.lognormal(0.0, j)) if j else \
            self.sim.t_compute

    def _t_msg(self) -> float:
        return costmodel.t_msg(self.nbytes, self.sim.net)

    def _t_update(self) -> float:
        return self.nbytes * self.sim.t_update_per_byte

    def t_exchange(self, schedule: str | None = None,
                   p: int | None = None) -> float:
        """α–β price of ONE full group exchange of the flat weights, from
        the registry the runtime executes."""
        sched = comm_schedules.get(schedule or self.sim.schedule)
        pp = p if p is not None else self.sim.n_workers
        topo = self.sim.topology
        if topo is not None and not topo.uniform:
            return sched.cost_topo(self.nbytes, pp, topo)
        return sched.cost(self.nbytes, pp, self.sim.net)

    # -- algorithms -----------------------------------------------------------
    def run(self, algorithm: str, total_iters: int,
            time_budget_s: Optional[float] = None) -> RunResult:
        if algorithm not in ALGORITHMS:
            raise ValueError(f"unknown algorithm '{algorithm}'")
        rng = np.random.RandomState(self.sim.seed)
        cfg, sim = self.cfg, self.sim
        P = sim.n_workers
        center = self.w0.clone()
        workers = [self.w0.clone() for _ in range(P)]
        vel = [torch.zeros_like(self.w0) for _ in range(P)]
        master_vel = torch.zeros_like(self.w0)
        history = []
        breakdown = {"fwd_bwd": 0.0, "param_comm": 0.0, "worker_update": 0.0,
                     "master_update": 0.0, "idle": 0.0}
        iters = 0
        last_eval = -1

        def evaluate(t):
            nonlocal last_eval
            if iters - last_eval >= sim.eval_every_iters:
                w_eval = center if "easgd" in algorithm else \
                    (center if algorithm.startswith(("async", "hogwild"))
                     else workers[0])
                history.append((t, iters, float(self.eval_fn(w_eval))))
                last_eval = iters

        def result(t):
            return RunResult(algorithm, history, t, iters, breakdown,
                             history[-1][2] if history else float("nan"),
                             center=center.clone(),
                             workers=torch.stack(workers))

        # ---------------- Original EASGD: round-robin, one worker at a time --
        if algorithm == "original_easgd":
            t = 0.0
            while iters < total_iters and \
                    (time_budget_s is None or t < time_budget_s):
                j = iters % P
                tc = self._t_compute(rng)
                grad = self.grad_fn(workers[j], iters, j)
                # serialized: 1/P of a round-robin cycle (2·P messages per
                # cycle → 2 here); P = 1 still pays its 2 messages
                t_rr = (self.t_exchange("round_robin") / P if P > 1
                        else 2 * self._t_msg())
                t += t_rr / 2               # master -> worker (W̄)
                t += tc
                t += t_rr / 2               # worker -> master (W_j)
                breakdown["param_comm"] += t_rr
                breakdown["fwd_bwd"] += tc
                easgd_flat.master_absorb_round_robin(center, workers[j],
                                                     vel[j], grad, cfg)
                t += 2 * self._t_update()
                breakdown["worker_update"] += self._t_update()
                breakdown["master_update"] += self._t_update()
                iters += 1
                evaluate(t)
            return result(t)

        # ---------------- synchronous family ---------------------------------
        if algorithm in easgd_flat.SYNC_FAMILY:
            t = 0.0
            steps = 0
            while iters < total_iters and \
                    (time_budget_s is None or t < time_budget_s):
                tcs = [self._t_compute(rng) for _ in range(P)]
                grads = [self.grad_fn(workers[i], steps, i) for i in range(P)]
                t_compute = max(tcs)
                t_comm = self.t_exchange()
                if algorithm == "sync_easgd":
                    # the exchange reads start-of-step weights and overlaps
                    # the compute (paper §6.1.3)
                    t += max(t_compute, t_comm)
                    mean_w = mean_rows(workers)
                    for i in range(P):
                        easgd_flat.worker_step(algorithm, workers[i], vel[i],
                                               grads[i], center, cfg)
                    easgd_flat.sync_master_easgd(center, mean_w, P, cfg)
                else:
                    # sync SGD: the gradient all-reduce cannot overlap
                    t += t_compute + t_comm
                    gmean = mean_rows(grads)
                    easgd_flat.sync_master_sgd(center, master_vel, gmean, cfg)
                    for i in range(P):
                        workers[i].copy_(center)
                breakdown["fwd_bwd"] += t_compute
                breakdown["param_comm"] += t_comm if algorithm == "sync_sgd" \
                    else max(0.0, t_comm - t_compute)
                t += 2 * self._t_update()
                breakdown["worker_update"] += self._t_update()
                breakdown["master_update"] += self._t_update()
                iters += P
                steps += 1
                evaluate(t)
            return result(t)

        # ---------------- asynchronous family (FCFS / lock-free) -------------
        # event heap of (time, seq, worker, phase)
        heap = []
        for i in range(P):
            heapq.heappush(heap, (self._t_compute(rng), i, i, "arrive"))
        master_free_at = 0.0
        seq = P
        t = 0.0
        lock_free = algorithm.startswith("hogwild")
        while iters < total_iters and heap and \
                (time_budget_s is None or t < time_budget_s):
            t, _, i, _ = heapq.heappop(heap)
            # worker i arrives with its contribution
            service = 2 * self._t_msg() + self._t_update()
            if not lock_free and t < master_free_at:
                breakdown["idle"] += master_free_at - t
                t = master_free_at          # FCFS: wait for the lock
            grad = self.grad_fn(workers[i], iters, i)
            easgd_flat.master_absorb(algorithm, center, master_vel,
                                     workers[i], vel[i], grad, cfg)
            if not lock_free:
                master_free_at = t + service
            breakdown["param_comm"] += 2 * self._t_msg()
            breakdown["master_update"] += self._t_update()
            tc = self._t_compute(rng)
            breakdown["fwd_bwd"] += tc
            heapq.heappush(heap, (t + service + tc, seq, i, "arrive"))
            seq += 1
            iters += 1
            evaluate(t)
        return result(t)

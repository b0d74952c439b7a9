"""The PS runtime's synchronous family, executed for real on the thread
transport (the port of the sync half of ``repro/ps/runtime.py``).

``sync_easgd`` and ``sync_sgd`` run barriered rounds. The weight (EASGD) or
gradient (SGD) all-reduce executes the registered schedule's message rounds
over the mailbox tensor in a comm-executor thread, between barriers A and B
of every round. Sync EASGD posts start-of-step weights BEFORE computing its
gradient, so the exchange overlaps compute (paper §6.1.3); Sync SGD needs
its gradient first, so it cannot (§5.1).

After barrier B every update goes through the fused kernels of
``kernels.elastic_update`` (their plain versions on the CPU): rank 0's
Sync EASGD launch also writes the new center, and Sync SGD's master update
is one launch by rank 0. The update runs over the whole row — it is
elementwise, so per-bucket launches would give the same bits.

Exactness kept from the reference:

* snapshot before apply — a round reads every payload (``clone``, not a
  view) before any receiver adds, so a ring round never reads values it
  already updated;
* the version-flipped center — round k reads ``center[k % 2]`` while rank
  0 writes the other buffer, so the center update needs no post-update
  barrier; after an odd round count the launcher copies ``center_alt``
  back;
* the padded mailbox — rows are ``n + (-n) % P`` long so chunked schedules
  divide them; workers write ``[:n]`` and updates read ``row[:n]``;
* one stream — every thread launches on PyTorch's current stream, so the
  host barriers order the device work exactly as they order the
  reference's numpy work; the clock is read only after a synchronise.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

import torch

from repro_torch.comm import rounds as comm_rounds
from repro_torch.comm.rounds import execute_rounds
from repro_torch.comm import schedules as comm_schedules
from repro_torch.core import costmodel, easgd_flat
from repro_torch.core.easgd import EASGDConfig
from repro_torch.kernels.elastic_update import (fused_sync_easgd_update,
                                                fused_sync_sgd_update)
from repro_torch.ps.transport import PSContext, ThreadTransport
from repro_torch.utils import timing
from repro_torch.utils.device import resolve_device

SYNC = easgd_flat.SYNC_FAMILY

# the PS runtime's default α–β network: only prices psum's butterfly-vs-ring
# choice for the sync rounds; the measured run does not consult it
_DEFAULT_NET = costmodel.PCIE3_X16


@dataclasses.dataclass(frozen=True)
class PSConfig:
    algorithm: str
    n_workers: int = 4
    transport: str = "thread"
    schedule: str = "ring"           # sync-family exchange ("auto" allowed)
    total_iters: int = 1000
    eval_every_iters: int = 200
    net: costmodel.Network = _DEFAULT_NET
    # netem-style wire emulation: every exchange round ADDITIONALLY sleeps
    # its α + max_frac·n·β under this network (None: shared memory is the
    # wire), restoring the interconnect-bound regime the paper ran in
    emulate_net: Optional[costmodel.Network] = None
    bucket_bytes: int = 0            # >0: execute the exchange bucket by
    #                                  bucket, cut at layer edges — a
    #                                  bitwise-identical view of the rounds
    # -- reference features this slice does not implement: setting one
    #    raises NotImplementedError instead of being ignored ----------------
    trace: bool = False
    telemetry: bool = False
    topology: Optional[costmodel.Topology] = None
    elastic: bool = False
    chaos: Optional[dict] = None

    def __post_init__(self):
        if self.algorithm not in SYNC:
            raise NotImplementedError(
                f"algorithm '{self.algorithm}' is not ported yet (this slice "
                f"runs {SYNC}); see ROADMAP.md, queue 1")
        if self.transport != "thread":
            raise NotImplementedError(
                f"transport '{self.transport}' is not ported yet (this slice "
                f"runs 'thread'); see ROADMAP.md, queue 1")
        unported = [f for f in ("trace", "telemetry", "elastic")
                    if getattr(self, f)]
        unported += [f for f in ("topology", "chaos")
                     if getattr(self, f) is not None]
        if unported:
            raise NotImplementedError(
                f"PSConfig {unported} are not ported yet; see ROADMAP.md, "
                f"queue 1")
        if self.n_workers < 1:
            raise ValueError(f"n_workers={self.n_workers}")
        if self.bucket_bytes < 0:
            raise ValueError(f"bucket_bytes={self.bucket_bytes}")
        if self.schedule != "auto":
            comm_schedules.get(self.schedule)        # validates the name

    def resolved_schedule(self, n_bytes: float) -> str:
        """Schedule name for an n-byte exchange ("auto": ``comm.choose``
        over ``self.net``)."""
        if self.schedule != "auto":
            return self.schedule
        return comm_schedules.choose(n_bytes, self.n_workers, self.net)

    def t_msg_emulated(self, n_bytes: float) -> float:
        """Per-message emulated wire time (0 without emulation)."""
        if self.emulate_net is None:
            return 0.0
        return costmodel.t_msg(n_bytes, self.emulate_net)


@dataclasses.dataclass
class PSResult:
    algorithm: str
    transport: str
    schedule: str
    device: str                      # the device the run was on
    history: list                    # [(wall_s, total_iters, metric)]
    total_time_s: float
    total_iters: int
    counters: dict                   # sync_rounds / messages / wire_bytes
    final_metric: float
    center: torch.Tensor
    workers: torch.Tensor            # (P, n) final worker weights


# ---------------------------------------------------------------------------
# the exchange: execute the registry's message rounds
# ---------------------------------------------------------------------------

def _sleep_until(deadline: float) -> None:
    """Absolute-deadline sleep on the monotonic clock: oversleeps do not
    accumulate."""
    dt = deadline - time.monotonic()
    if dt > 0:
        time.sleep(dt)


def _comm_executor(ctx: PSContext) -> None:
    """The sync family's 'NIC': runs the all-reduce rounds between barriers
    A and B of every training round. sync_sgd's round has a third barrier
    (C: master update complete)."""
    v = ctx.views()
    counters = {"sync_rounds": ctx.sync_rounds, "messages": ctx.messages,
                "wire_bytes": ctx.wire_bytes}
    tau = max(ctx.easgd.tau, 1)
    n_rounds = -(-ctx.cfg.total_iters // (ctx.cfg.n_workers * tau))
    third = ctx.cfg.algorithm == "sync_sgd"
    # emulated wire: one exchange costs Σ (α + max_frac·n·β) on top of the
    # real copies, paced as one absolute deadline per exchange
    t_wire = sum(ctx.cfg.t_msg_emulated(max(m.frac for m in rnd) * ctx.n * 8)
                 for rnd in ctx.rounds)
    try:
        for _ in range(n_rounds):
            ctx.barrier.wait()       # A: mailboxes posted
            deadline = time.monotonic() + t_wire
            execute_rounds(v.mailbox, ctx.n, ctx.rounds, counters,
                           boundaries=ctx.boundaries)
            if t_wire:
                _sleep_until(deadline)
            ctx.barrier.wait()       # B: exchange complete
            if third:
                ctx.barrier.wait()   # C: master update complete
    except threading.BrokenBarrierError:
        pass
    except Exception as e:           # noqa: BLE001 — surfaced by run_ps
        ctx.fail(e)


# ---------------------------------------------------------------------------
# worker loop
# ---------------------------------------------------------------------------

def worker_main(ctx: PSContext, wid: int) -> None:
    w0, grad_fn, _ = ctx.problem
    # warm caches before the start gate so the measured clock sees steady
    # state; ids ≤ −2 are private minibatch streams (the workers' own
    # streams, and therefore parity with the reference, are untouched)
    wu = w0.clone()
    for k in range(2):
        grad_fn(wu, k, -(wid + 2))
    ctx.start_barrier.wait()
    _sync_worker(ctx, wid, grad_fn)


def _sync_worker(ctx, wid, grad_fn):
    """Barriered rounds; the barriers are shared with the comm executor.

    sync_easgd: post W_t → [A] → grad ∥ all-reduce → [B] → fused update
                (worker rule; rank 0 also writes the flipped center).
    sync_sgd:   grad → post → [A] → all-reduce → [B] → rank 0 fused
                momentum step on ḡ → [C] → all copy W̄.
    """
    v, e = ctx.views(), ctx.easgd
    algo, P, total = ctx.cfg.algorithm, ctx.cfg.n_workers, ctx.cfg.total_iters
    w, vel = v.workers_w[wid], v.workers_v[wid]
    n = ctx.n
    row = v.mailbox[0, :n]           # the exchanged sum after barrier B
    tau = max(e.tau, 1)
    n_rounds = -(-total // (P * tau))
    it = 0

    def _local_block():
        """τ−1 local-only steps before the barriered exchange step."""
        nonlocal it
        for _ in range(tau - 1):
            g = grad_fn(w, it, wid)
            easgd_flat.local_step(algo, w, vel, g, e)
            it += 1

    if algo == "sync_easgd":
        versions = (v.center, v.center_alt)
        for step in range(n_rounds):
            _local_block()
            c_read, c_write = versions[step % 2], versions[(step + 1) % 2]
            v.mailbox[wid, :n].copy_(w)      # start-of-exchange weights
            ctx.barrier.wait()               # A — exchange begins
            grad = grad_fn(w, it, wid)       # …and overlaps this compute
            it += 1
            ctx.barrier.wait()               # B — sum of W_t in every row
            fused_sync_easgd_update(w, grad, c_read, row, P, e.eta, e.rho,
                                    center_out=c_write if wid == 0 else None)
            if wid == 0:
                ctx.iters.value += P * tau
        return
    for step in range(n_rounds):             # sync_sgd
        _local_block()
        grad = grad_fn(w, it, wid)
        it += 1
        v.mailbox[wid, :n].copy_(grad)
        ctx.barrier.wait()                   # A — gradient all-reduce
        ctx.barrier.wait()                   # B — workers idle through both
        if wid == 0:
            fused_sync_sgd_update(v.center, v.master_vel, row, P, e.eta, e.mu)
            ctx.iters.value += P * tau
        ctx.barrier.wait()                   # C — W̄ updated
        w.copy_(v.center)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def run_ps(problem, easgd: EASGDConfig, cfg: PSConfig, device=None,
           join_timeout_s: float = 600.0) -> PSResult:
    """Run one sync-family algorithm for real on ``device`` (default: the
    card). ``problem`` is a ``ProblemSpec`` (built on ``device``) or a
    prebuilt ``(w0, grad_fn, eval_fn)`` triple whose rows live there."""
    dev = resolve_device(device)
    tr = ThreadTransport(dev)
    built = problem.build(dev) if hasattr(problem, "build") else problem
    w0, grad_fn, eval_fn = built
    w0 = w0.to(dev, torch.float64)
    n, P = w0.numel(), cfg.n_workers
    sched_name = cfg.resolved_schedule(n * 8)
    rounds = comm_schedules.get(sched_name).rounds(P, n * 8, cfg.net)
    padded = n + (-n) % P

    shapes = {"center": (n,), "center_alt": (n,), "master_vel": (n,),
              "workers_w": (P, n), "workers_v": (P, n),
              "mailbox": (P + 1, padded)}
    buffers = {k: tr.array(*shape) for k, shape in shapes.items()}
    prims = {
        "barrier": tr.barrier(P + 1),            # workers + comm executor
        "start_barrier": tr.barrier(P + 1),      # workers + launcher
        "iters": tr.int_slot(), "sync_rounds": tr.int_slot(),
        "messages": tr.int_slot(), "wire_bytes": tr.int_slot(),
    }
    bounds = None
    if cfg.bucket_bytes > 0:
        # layer edges come from the problem when it declares them; uniform
        # slabs otherwise — either way the exchange math is bitwise the same
        bounds = comm_rounds.default_bucket_boundaries(
            getattr(grad_fn, "layer_sizes", None), padded, cfg.bucket_bytes)
    ctx = PSContext(cfg, easgd, n, buffers, (w0, grad_fn, eval_fn), rounds,
                    prims, boundaries=bounds)
    v = ctx.views()
    v.center.copy_(w0)
    v.center_alt.copy_(w0)
    v.workers_w.copy_(w0[None])

    handles = tr.launch(ctx)
    comm_thread = threading.Thread(target=_comm_executor, args=(ctx,),
                                   daemon=True)
    comm_thread.start()

    def _fail(msg):
        ctx.barrier.abort()
        ctx.start_barrier.abort()
        tr.join(handles, timeout=5.0)
        comm_thread.join(timeout=5.0)
        cause = ctx.errors[0] if ctx.errors else None
        raise RuntimeError(f"{msg} (algorithm={cfg.algorithm}, "
                           f"device={dev})") from cause

    try:
        ctx.start_barrier.wait(join_timeout_s)   # workers warmed up
    except threading.BrokenBarrierError:
        _fail("ps workers failed to start")
    t0 = time.perf_counter()
    history, last_eval = [], 0
    deadline = t0 + join_timeout_s
    while any(h.is_alive() for h in handles):
        if ctx.errors:
            break
        it = ctx.iters.value
        if it - last_eval >= cfg.eval_every_iters:
            history.append((time.perf_counter() - t0, it,
                            float(eval_fn(v.center.clone()))))
            last_eval = it
        if time.perf_counter() > deadline:
            _fail(f"ps run exceeded {join_timeout_s}s")
        time.sleep(1e-3)
    timing.synchronize(dev)                  # the clock covers device work
    total_time = time.perf_counter() - t0
    ok = tr.join(handles, timeout=5.0)
    comm_thread.join(timeout=5.0)
    if ctx.errors or not ok or comm_thread.is_alive():
        _fail("ps run failed")

    n_sync_rounds = -(-cfg.total_iters // (P * max(easgd.tau, 1)))
    if cfg.algorithm == "sync_easgd" and n_sync_rounds % 2 == 1:
        v.center.copy_(v.center_alt)         # final version of the flip
    final = float(eval_fn(v.center.clone()))
    history.append((total_time, ctx.iters.value, final))
    counters = {"sync_rounds": ctx.sync_rounds.value,
                "messages": ctx.messages.value,
                "wire_bytes": ctx.wire_bytes.value}
    return PSResult(
        algorithm=cfg.algorithm, transport=cfg.transport,
        schedule=sched_name, device=str(dev), history=history,
        total_time_s=total_time, total_iters=ctx.iters.value,
        counters=counters, final_metric=final, center=v.center.clone(),
        workers=v.workers_w.clone())

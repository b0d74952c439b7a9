"""The PS runtime: the paper's nine algorithms executed for real on the
thread, process and tcp transports, and the DES cross-check (the port of
``repro/ps/runtime.py``). ``transport="tcp"`` hands the whole run to the
master server of ``net.server`` (workers are processes at the other end of
real sockets); the PSResult comes back in the same shape.

Concurrency disciplines (paper §4–5):

* ``original_easgd`` — round-robin TURNSTILE: the master serves workers in
  rank order, each computing its gradient inside its turn (Θ(P) serialized).
* ``async_*`` — FCFS on the master lock; with ``deterministic=True`` the
  turnstile replaces the lock, which is the DES's zero-jitter event order
  (the bitwise DES↔real cross-check runs in this mode).
* ``hogwild_*`` — the same absorb with no lock. On the card the calls of
  different workers interleave between kernels (one stream: each
  elementwise op is atomic against the others), on the CPU also within an
  op; held, as in the reference, only by finiteness, the iteration quota
  and the message counts.
* ``sync_*`` — barriered rounds. The weight (EASGD) or gradient (SGD)
  all-reduce executes the registered schedule's message rounds over the
  mailbox tensor in a comm-executor thread, between barriers A and B of
  every round. Sync EASGD posts start-of-step weights before computing its
  gradient, so the exchange overlaps compute (§6.1.3); Sync SGD cannot.
  After barrier B the updates go through the fused kernels of
  ``kernels.elastic_update`` (their plain versions on the CPU): rank 0's
  Sync EASGD launch also writes the new center, Sync SGD's master update is
  one launch by rank 0.

τ (``EASGDConfig.tau``) is honoured by every loop: τ−1 local-only steps
between exchanges.

A ``PSConfig.topology`` (sync family, thread or tcp) replaces the emulated
wire with a two-level fabric: each exchange is paced to ``t_rounds`` over
its messages' link classes, hierarchical groups its ring by host, and
"auto" ranks the schedules over a ``LinkProfile`` measured on the live
machinery (``measured_link_profile``; ``calibrate`` builds one). The
pacing sleeps between the exchange and barrier B, never inside an
update, so the bits are the flat run's whenever the schedule is.

Exactness kept from the reference: the same operation order in every
update (``core.easgd_flat``); snapshot-before-apply in every exchange
round; the version-flipped center of Sync EASGD (copied back by the
launcher after an odd round count); the padded mailbox (rows of
``n + (-n) % P``). On the thread transport every thread launches on
PyTorch's current stream, so the host primitives order the device work;
on the process transport ``ctx.fence()`` (a device synchronise) completes
a worker's writes before any primitive hands them on. The clock is read
only after a synchronise.

Tracing (``PSConfig.trace``): each worker loop, the comm executor and
``execute_rounds`` record spans (``obs.trace``) exactly where the
reference does; on the card every span is closed after a synchronise of
the thread's current stream, so device time lands in the span that queued
it. The thread transport's threads share one stream, so there a span also
waits for the other threads' queued work. The merged timeline and its
Table-3 breakdown come back on ``PSResult.trace``.
"""
from __future__ import annotations

import dataclasses
import os
import statistics
import threading
import time
from typing import Optional

import torch

from repro_torch import kernels
from repro_torch.comm import rounds as comm_rounds
from repro_torch.comm.rounds import execute_rounds
from repro_torch.comm import schedules as comm_schedules
from repro_torch.core import costmodel, easgd_flat
from repro_torch.core.async_engine import ALGORITHMS, PSEngine, SimConfig
from repro_torch.core.easgd import EASGDConfig
from repro_torch.kernels.elastic_update import (fused_sync_easgd_update,
                                                fused_sync_sgd_update)
from repro_torch.obs import report as obs_report
from repro_torch.obs import trace as obs_trace
from repro_torch.ps.transport import PSContext, get_transport
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
    transport: str = "thread"        # "thread" | "process" | "tcp"
    schedule: str = "ring"           # sync-family exchange ("auto" allowed)
    total_iters: int = 1000
    deterministic: bool = False      # cyclic admission == DES zero-jitter
    eval_every_iters: int = 200
    net: costmodel.Network = _DEFAULT_NET
    # netem-style wire emulation: every master message / exchange round
    # additionally sleeps its α + nβ under this network (None: device
    # memory, or the real socket, is the wire), restoring the
    # interconnect-bound regime the paper ran in. Charge the same network
    # to the DES (Calibration.sim_config(net=...)) for a fair cross-check
    emulate_net: Optional[costmodel.Network] = None
    seed: int = 0
    # -- tcp transport only (net) -------------------------------------------
    wire_compression: str = "none"   # "none" | "sign_ef": per-link payload
    #                                  codec with error-feedback state
    sync_plane: str = "master"       # "master": the master executes the
    #                                  sync family's rounds on its mailbox
    #                                  (Θ(P·N) through its links a round);
    #                                  "p2p": the workers execute them over
    #                                  worker↔worker links (net.peer)
    tcp_host: str = "127.0.0.1"
    tcp_port: int = 0                # 0: ephemeral
    spawn_workers: bool = True       # False: external workers join
    hb_interval_s: float = 2.0       # worker heartbeat period
    hb_timeout_s: float = 60.0       # the master declares a silent link dead
    bucket_bytes: int = 0            # >0: execute the exchange bucket by
    #                                  bucket, cut at layer edges — a
    #                                  bitwise-identical view of the rounds
    overlap: bool = True             # p2p: stream buckets while the gradient
    #                                  and the per-bucket updates compute;
    #                                  False runs the exchange first (the
    #                                  paper's no-overlap baseline)
    # -- observability (obs) ------------------------------------------------
    trace: bool = False              # record per-thread spans and return
    #                                  the merged timeline with its Table-3
    #                                  breakdown on PSResult.trace; off: no
    #                                  tracer, no timestamp, no synchronise
    trace_dir: Optional[str] = None  # spill worker trace buffers here
    #                                  (process workers always spill; a
    #                                  temporary directory when unset)
    # -- live telemetry plane (obs.live) ------------------------------------
    telemetry: bool = False          # stream heartbeat telemetry and master
    #                                  gauges into a ring-buffer store, run
    #                                  the online straggler / health
    #                                  detector, serve STATS frames (tcp)
    #                                  and attach PSResult.health. Off: no
    #                                  store, no sampler, no acceptor
    telemetry_jsonl: Optional[str] = None    # one JSON line per sample to
    #                                  this path (implies telemetry)
    telemetry_interval_s: float = 0.0        # sampler / detector period;
    #                                  0 follows hb_interval_s
    straggler_factor: float = 2.0    # flag a worker whose per-iteration
    #                                  delay exceeds this × the median
    link_slow: Optional[tuple] = None        # per-wid multipliers (≥ 1) of
    #                                  the emulated wire's pacing: a
    #                                  controlled straggler on the clock
    #                                  only (tcp + emulate_net)
    # -- elastic membership (ft.membership) ---------------------------------
    elastic: bool = False            # tcp only: a worker death or
    #                                  preemption becomes a RECONFIGURE
    #                                  epoch instead of a dead run, and a
    #                                  respawned worker rejoins mid-run (p2p)
    chaos: Optional[dict] = None     # deterministic fault injection
    #                                  (ft.chaos.ChaosSpec fields: wid,
    #                                  kill_at_iter, signal "kill" | "term",
    #                                  dial_refuse_s), handed to the spawned
    #                                  workers in REPRO_CHAOS; tcp only
    # -- heterogeneous fabric (topology-aware scale-out) --------------------
    topology: Optional[costmodel.Topology] = None    # hosts × slots link
    #                                  model: it replaces emulate_net for
    #                                  the sync family — every pacing sleep
    #                                  (master rounds, p2p segment
    #                                  deadlines) prices each message over
    #                                  its link class (fast intra-host /
    #                                  slow cross-host), and "auto" ranks
    #                                  the schedules on the topology
    link_profile: Optional[costmodel.LinkProfile] = None     # a measured
    #                                  per-link-class profile
    #                                  (measured_link_profile / calibrate):
    #                                  "auto" prices over it instead

    def __post_init__(self):
        if self.algorithm not in ALGORITHMS:
            raise ValueError(f"unknown algorithm '{self.algorithm}', have "
                             f"{ALGORITHMS}")
        if self.transport not in ("thread", "process", "tcp"):
            raise ValueError(f"unknown transport '{self.transport}'")
        if self.n_workers < 1:
            raise ValueError(f"n_workers={self.n_workers}")
        if self.bucket_bytes < 0:
            raise ValueError(f"bucket_bytes={self.bucket_bytes}")
        if self.wire_compression not in ("none", "sign_ef"):
            raise ValueError(f"wire_compression='{self.wire_compression}'")
        # the shared-memory transports have no wire to compress: a config
        # claiming compression there would report raw bytes as compressed
        if self.wire_compression != "none" and self.transport != "tcp":
            raise ValueError(
                f"wire_compression='{self.wire_compression}' is a "
                f"tcp-transport feature (transport='{self.transport}' moves "
                f"no frames)")
        if self.sync_plane not in ("master", "p2p"):
            raise ValueError(f"sync_plane='{self.sync_plane}'")
        # the p2p data plane is worker↔worker sockets executing the sync
        # family's rounds: it has no meaning off tcp or off that family
        if self.sync_plane == "p2p" and (self.transport != "tcp"
                                         or self.algorithm not in SYNC):
            raise ValueError(
                f"sync_plane='p2p' needs transport='tcp' and a sync-family "
                f"algorithm (got transport='{self.transport}', "
                f"algorithm='{self.algorithm}')")
        if self.hb_interval_s <= 0 or self.hb_timeout_s <= 0:
            raise ValueError(f"hb_interval_s={self.hb_interval_s}, "
                             f"hb_timeout_s={self.hb_timeout_s}")
        if self.schedule != "auto":
            comm_schedules.get(self.schedule)        # validates the name
        if self.telemetry_interval_s < 0.0:
            raise ValueError(
                f"telemetry_interval_s={self.telemetry_interval_s}")
        if self.straggler_factor <= 1.0:
            raise ValueError(f"straggler_factor={self.straggler_factor} "
                             f"(must exceed 1)")
        if self.link_slow is not None:
            if self.transport != "tcp":
                raise ValueError(
                    f"link_slow stretches per-link wire pacing — only the "
                    f"tcp transport has per-worker links (transport="
                    f"'{self.transport}')")
            if self.emulate_net is None:
                raise ValueError(
                    "link_slow multiplies emulated wire time; without "
                    "emulate_net there is no pacing to stretch")
            if len(self.link_slow) != self.n_workers:
                raise ValueError(
                    f"link_slow needs one factor per worker "
                    f"({len(self.link_slow)} != {self.n_workers})")
            if not all(f >= 1.0 for f in self.link_slow):
                raise ValueError(f"link_slow={self.link_slow} (each ≥ 1)")
        if self.elastic and self.transport != "tcp":
            raise ValueError(
                f"elastic membership reconfigures real links — only the "
                f"tcp transport has them (transport='{self.transport}')")
        if self.chaos is not None:
            if self.transport != "tcp":
                raise ValueError(
                    f"chaos injection targets spawned tcp worker processes "
                    f"(transport='{self.transport}')")
            from repro_torch.ft.chaos import ChaosSpec
            ChaosSpec.from_config(self.chaos)    # validates the fields
        if self.topology is not None:
            if self.algorithm not in SYNC:
                raise ValueError(
                    f"a topology prices the sync family's exchange rounds — "
                    f"algorithm '{self.algorithm}' has none")
            if self.topology.p != self.n_workers:
                raise ValueError(
                    f"topology is {self.topology.hosts}x"
                    f"{self.topology.slots}={self.topology.p} slots but "
                    f"n_workers={self.n_workers}")
            if self.transport not in ("thread", "tcp"):
                raise ValueError(
                    f"topology pacing exists on the thread and tcp planes "
                    f"(transport='{self.transport}')")
            if self.emulate_net is not None:
                raise ValueError(
                    "topology REPLACES emulate_net: per-link pacing and the "
                    "global emulated wire would double-charge the clock")
            if self.elastic:
                raise ValueError(
                    "topology-aware pacing + elastic membership are not yet "
                    "composed (an epoch's survivors no longer tile the "
                    "declared hosts x slots grid)")
        if self.link_profile is not None and self.topology is None:
            raise ValueError(
                "link_profile rides a topology — set PSConfig.topology to "
                "the fabric the profile was measured on")

    @property
    def telemetry_on(self) -> bool:
        return self.telemetry or self.telemetry_jsonl is not None

    def telemetry_period_s(self) -> float:
        return self.telemetry_interval_s or self.hb_interval_s

    def link_slow_factor(self, wid: int) -> float:
        if self.link_slow is None:
            return 1.0
        return float(self.link_slow[wid])

    def resolved_schedule(self, n_bytes: float,
                          profile: Optional[costmodel.LinkProfile] = None
                          ) -> str:
        """Schedule name for an n-byte exchange. "auto" ranks the
        candidates over, in this order: the ``profile`` passed,
        ``self.link_profile``, ``self.topology``, else the flat
        ``self.net``."""
        if self.schedule != "auto":
            return self.schedule
        prof = profile if profile is not None else self.link_profile
        if prof is not None:
            return comm_schedules.choose(n_bytes, self.n_workers,
                                         profile=prof)
        if self.topology is not None:
            return comm_schedules.choose(n_bytes, self.n_workers,
                                         topology=self.topology)
        return comm_schedules.choose(n_bytes, self.n_workers, self.net)

    def hb_interval_eff_s(self, p: Optional[int] = None) -> float:
        """Heartbeat period scaled with the mesh: × max(1, P/16), so every
        P ≤ 16 keeps exactly its configured period and P = 64 beats 4×
        slower (P links at a fixed period flood the master's readers)."""
        pp = self.n_workers if p is None else p
        return self.hb_interval_s * max(1.0, pp / 16.0)

    def hb_timeout_eff_s(self, p: Optional[int] = None) -> float:
        """Staleness threshold: never below the configured timeout, and at
        least 12 effective periods."""
        return max(self.hb_timeout_s, 12.0 * self.hb_interval_eff_s(p))

    def t_msg_emulated(self, n_bytes: float) -> float:
        """Per-message emulated wire time (0 without emulation)."""
        if self.emulate_net is None:
            return 0.0
        return costmodel.t_msg(n_bytes, self.emulate_net)


@dataclasses.dataclass
class PSResult:
    algorithm: str
    transport: str
    schedule: str                    # the sync exchange, "master" otherwise
    device: str                      # the device the run was on
    history: list                    # [(wall_s, total_iters, metric)]
    total_time_s: float
    total_iters: int
    counters: dict                   # sync_rounds / messages / wire_bytes
    final_metric: float
    center: torch.Tensor
    workers: torch.Tensor            # (P, n) final worker weights
    trace: Optional[dict] = None     # cfg.trace: the merged, clock-aligned
    #                                  timeline (obs.report.merge_traces)
    #                                  with a "report" breakdown
    health: Optional[dict] = None    # cfg.telemetry: the live plane's
    #                                  summary (obs.live.LiveMonitor.health:
    #                                  events, flagged workers, the last
    #                                  telemetry per worker); cfg.elastic
    #                                  adds the membership table and epoch


# ---------------------------------------------------------------------------
# the sync-family exchange: execute the registry's message rounds
# ---------------------------------------------------------------------------

def _sleep_until(deadline: float) -> None:
    """Absolute-deadline sleep on the monotonic clock: oversleeps do not
    accumulate."""
    dt = deadline - time.monotonic()
    if dt > 0:
        time.sleep(dt)


def _tracer(ctx: PSContext, name: str, wid: int = -1):
    """A span recorder for this thread when ``cfg.trace`` is on (its clock
    synchronises the thread's current stream on the card), else None."""
    if not ctx.cfg.trace:
        return None
    return obs_trace.tracer(name, wid=wid,
                            sync=timing.stream_sync(ctx.device))


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
    tr = _tracer(ctx, "comm")
    # emulated wire: one exchange costs Σ (α + max_frac·n·β) on top of the
    # real copies, paced as one absolute deadline per exchange; under a
    # topology each round is priced over its messages' link classes
    if ctx.cfg.topology is not None:
        t_wire = comm_rounds.t_rounds(ctx.rounds, ctx.n * 8,
                                      topology=ctx.cfg.topology)
    else:
        t_wire = sum(
            ctx.cfg.t_msg_emulated(max(m.frac for m in rnd) * ctx.n * 8)
            for rnd in ctx.rounds)
    try:
        for _ in range(n_rounds):
            if tr is not None:
                t0 = tr.now()
            ctx.barrier.wait()       # A: mailboxes posted
            if tr is not None:
                tr.record(obs_trace.BARRIER, t0, (tx := tr.now()), 0)
            deadline = time.monotonic() + t_wire
            execute_rounds(v.mailbox, ctx.n, ctx.rounds, counters,
                           boundaries=ctx.boundaries, tracer=tr)
            if t_wire:
                _sleep_until(deadline)
            ctx.fence()
            if tr is not None:
                tr.record(obs_trace.EXCHANGE, tx, (t0 := tr.now()))
            ctx.barrier.wait()       # B: exchange complete
            if tr is not None:
                tr.record(obs_trace.BARRIER, t0, tr.now(), 1)
            if third:
                ctx.barrier.wait()   # C: master update complete
    except threading.BrokenBarrierError:
        pass
    except Exception as e:           # noqa: BLE001 — surfaced by run_ps
        ctx.fail(e)


# ---------------------------------------------------------------------------
# worker loops
# ---------------------------------------------------------------------------

def worker_main(ctx: PSContext, wid: int) -> None:
    w0, grad_fn, _ = ctx.built_problem()
    # warm caches before the start gate so the measured clock sees steady
    # state; ids ≤ −2 are private minibatch streams (the workers' own
    # streams, and therefore the DES↔real iterate equality, are untouched)
    wu = w0.to(ctx.device, torch.float64).clone()
    for k in range(2):
        grad_fn(wu, k, -(wid + 2))
    ctx.start_barrier.wait()
    tr = _tracer(ctx, "main", wid)
    algo = ctx.cfg.algorithm
    if algo in SYNC:
        _sync_worker(ctx, wid, grad_fn, tr)
    elif algo == "original_easgd" or ctx.cfg.deterministic:
        _turnstile_worker(ctx, wid, grad_fn, tr)
    elif algo.startswith("hogwild"):
        _hogwild_worker(ctx, wid, grad_fn, tr)
    else:
        _fcfs_worker(ctx, wid, grad_fn, tr)
    if tr is not None and ctx.cfg.trace_dir:
        # process transport: the registry dies with this process, so the
        # buffer goes to disk for the launcher to merge (perf_counter is
        # system-wide on one host: the clock offset is 0)
        obs_trace.dump_spill(ctx.cfg.trace_dir, wid, {
            "clock": {"offset_s": 0.0, "rtt_s": 0.0},
            "threads": {"main": tr.spans()},
            "dropped": tr.dropped,
        })


def _count_exchange(ctx, iters: int) -> None:
    """One worker↔master exchange: both messages of the full row."""
    ctx.iters.value += iters
    ctx.messages.value += 2
    ctx.wire_bytes.value += 2 * ctx.n * 8


def _turnstile_worker(ctx, wid, grad_fn, tr=None):
    """Strict cyclic admission: worker ``turn % P`` owns the master next.
    This is Original EASGD's round-robin wire and, for the async family
    under ``deterministic=True``, exactly the DES zero-jitter event order.

    original_easgd computes its gradient inside the turn (the whole
    pipeline serializes, the Θ(P) behaviour the paper attacks). The async
    family computes ahead of the turn (w⁽ⁱ⁾ changes only in its own turn
    and the gradient never reads W̄, so the iterates are the same), and so
    computes one gradient more than it uses after its last turn."""
    v, e = ctx.views(), ctx.easgd
    algo, P, total = ctx.cfg.algorithm, ctx.cfg.n_workers, ctx.cfg.total_iters
    w, vel = v.workers_w[wid], v.workers_v[wid]
    serial_compute = algo == "original_easgd"
    t_msg = ctx.cfg.t_msg_emulated(ctx.n * 8)
    tau = max(e.tau, 1)
    total_turns = -(-total // tau)      # one turn = one exchange = τ steps
    local_step = 0

    def _tau_block():
        """τ−1 local-only steps + the exchange gradient."""
        nonlocal local_step
        if tr is not None:
            t0 = tr.now()
        for _ in range(tau - 1):
            g = grad_fn(w, local_step, wid)
            easgd_flat.local_step(algo, w, vel, g, e)
            local_step += 1
        if tr is not None and tau > 1:
            tr.record(obs_trace.LOCAL_STEP, t0, (t0 := tr.now()), tau - 1)
        g = grad_fn(w, local_step, wid)
        local_step += 1
        if tr is not None:
            tr.record(obs_trace.COMPUTE, t0, tr.now())
        return g

    while True:
        grad = None if serial_compute else _tau_block()
        if tr is not None:
            t0 = tr.now()
        with ctx.turn_cond:
            while ctx.turn.value < total_turns and ctx.turn.value % P != wid:
                ctx.turn_cond.wait(0.05)
            if tr is not None:
                tr.record(obs_trace.TURN_WAIT, t0, (t0 := tr.now()))
            if ctx.turn.value >= total_turns:
                ctx.turn_cond.notify_all()
                return
            if t_msg:                        # master → worker (W̄ down)
                _sleep_until(time.monotonic() + t_msg)
                if tr is not None:
                    tr.record(obs_trace.COMM_WAIT, t0, (t0 := tr.now()), 0)
            if serial_compute:
                grad = _tau_block()
                if tr is not None:
                    t0 = tr.now()
                easgd_flat.master_absorb_round_robin(
                    v.center, w, vel, grad, e)
            else:
                easgd_flat.master_absorb(
                    algo, v.center, v.master_vel, w, vel, grad, e)
            if tr is not None:
                tr.record(obs_trace.UPDATE, t0, (t0 := tr.now()))
            if t_msg:                        # worker → master (W⁽ⁱ⁾ up)
                _sleep_until(time.monotonic() + t_msg)
                if tr is not None:
                    tr.record(obs_trace.COMM_WAIT, t0, tr.now(), 1)
            ctx.fence()
            ctx.turn.value += 1
            _count_exchange(ctx, tau)
            ctx.turn_cond.notify_all()


def _fcfs_worker(ctx, wid, grad_fn, tr=None):
    """Async family: first come, first served on the master lock. A worker
    that finds the quota met under the lock returns with its gradient
    unused, so a run computes up to P − 1 gradients more than it uses."""
    v, e = ctx.views(), ctx.easgd
    algo, total = ctx.cfg.algorithm, ctx.cfg.total_iters
    w, vel = v.workers_w[wid], v.workers_v[wid]
    t_msg = ctx.cfg.t_msg_emulated(ctx.n * 8)
    tau = max(e.tau, 1)
    local_step = 0
    while ctx.iters.value < total:
        if tr is not None:
            t0 = tr.now()
        for _ in range(tau - 1):             # τ−1 local-only steps
            g = grad_fn(w, local_step, wid)
            easgd_flat.local_step(algo, w, vel, g, e)
            local_step += 1
        if tr is not None and tau > 1:
            tr.record(obs_trace.LOCAL_STEP, t0, (t0 := tr.now()), tau - 1)
        grad = grad_fn(w, local_step, wid)
        local_step += 1
        if tr is not None:
            tr.record(obs_trace.COMPUTE, t0, (t0 := tr.now()))
        deadline = None
        with ctx.master_lock:
            if tr is not None:
                tr.record(obs_trace.TURN_WAIT, t0, (t0 := tr.now()))
            if ctx.iters.value >= total:
                return
            if t_msg:
                # the ONE master link serializes both messages of every
                # exchange: reserve wire time as an absolute deadline (the
                # sleep happens outside the lock — the wire is busy, the
                # master is not)
                start = max(time.monotonic(), ctx.wire_free_at.value)
                deadline = start + 2 * t_msg
                ctx.wire_free_at.value = deadline
            easgd_flat.master_absorb(
                algo, v.center, v.master_vel, w, vel, grad, e)
            ctx.fence()
            _count_exchange(ctx, tau)
            if tr is not None:
                tr.record(obs_trace.UPDATE, t0, (t0 := tr.now()))
        if deadline is not None:
            _sleep_until(deadline)
            if tr is not None:
                tr.record(obs_trace.COMM_WAIT, t0, tr.now())


def _hogwild_worker(ctx, wid, grad_fn, tr=None):
    """The same absorb as FCFS with no lock: concurrent in-place updates of
    the shared center interleave for real. Termination is by per-worker
    quota. The counters, racy in the reference, are bumped under their own
    lock (across processes ``+=`` on a shared slot loses updates); the
    absorb takes none."""
    v, e = ctx.views(), ctx.easgd
    algo, P, total = ctx.cfg.algorithm, ctx.cfg.n_workers, ctx.cfg.total_iters
    w, vel = v.workers_w[wid], v.workers_v[wid]
    t_msg = ctx.cfg.t_msg_emulated(ctx.n * 8)
    tau = max(e.tau, 1)
    quota = total // P + (1 if wid < total % P else 0)
    for local_step in range(quota):
        if tr is not None:
            t0 = tr.now()
        grad = grad_fn(w, local_step, wid)
        if (local_step + 1) % tau and local_step != quota - 1:
            easgd_flat.local_step(algo, w, vel, grad, e)   # τ local-only
            ctx.fence()
            if tr is not None:
                tr.record(obs_trace.LOCAL_STEP, t0, tr.now(), 1)
            with ctx.count_lock:
                ctx.iters.value += 1
            continue
        if tr is not None:
            tr.record(obs_trace.COMPUTE, t0, (t0 := tr.now()))
        deadline = (time.monotonic() + 2 * t_msg) if t_msg else None
        easgd_flat.master_absorb(
            algo, v.center, v.master_vel, w, vel, grad, e)
        if tr is not None:
            tr.record(obs_trace.UPDATE, t0, (t0 := tr.now()))
        if deadline is not None:
            _sleep_until(deadline)           # lock-free: wire times OVERLAP
            if tr is not None:
                tr.record(obs_trace.COMM_WAIT, t0, tr.now())
        ctx.fence()
        with ctx.count_lock:
            _count_exchange(ctx, 1)


def _sync_worker(ctx, wid, grad_fn, tr=None):
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
        if tr is not None and tau > 1:
            t0 = tr.now()
        for _ in range(tau - 1):
            g = grad_fn(w, it, wid)
            easgd_flat.local_step(algo, w, vel, g, e)
            it += 1
        if tr is not None and tau > 1:
            tr.record(obs_trace.LOCAL_STEP, t0, tr.now(), tau - 1)

    if algo == "sync_easgd":
        versions = (v.center, v.center_alt)
        for step in range(n_rounds):
            _local_block()
            c_read, c_write = versions[step % 2], versions[(step + 1) % 2]
            v.mailbox[wid, :n].copy_(w)      # start-of-exchange weights
            ctx.fence()
            if tr is not None:
                t0 = tr.now()
            ctx.barrier.wait()               # A — exchange begins
            if tr is not None:
                tr.record(obs_trace.BARRIER, t0, (t0 := tr.now()), 0)
            grad = grad_fn(w, it, wid)       # …and overlaps this compute
            it += 1
            if tr is not None:
                tr.record(obs_trace.COMPUTE, t0, (t0 := tr.now()))
            ctx.barrier.wait()               # B — sum of W_t in every row
            if tr is not None:
                tr.record(obs_trace.BARRIER, t0, (t0 := tr.now()), 1)
            fused_sync_easgd_update(w, grad, c_read, row, P, e.eta, e.rho,
                                    center_out=c_write if wid == 0 else None)
            if wid == 0:
                ctx.fence()
                ctx.iters.value += P * tau
            if tr is not None:
                tr.record(obs_trace.UPDATE, t0, tr.now())
        return
    for step in range(n_rounds):             # sync_sgd
        _local_block()
        if tr is not None:
            t0 = tr.now()
        grad = grad_fn(w, it, wid)
        it += 1
        if tr is not None:
            tr.record(obs_trace.COMPUTE, t0, (t0 := tr.now()))
        v.mailbox[wid, :n].copy_(grad)
        ctx.fence()
        ctx.barrier.wait()                   # A — gradient all-reduce
        ctx.barrier.wait()                   # B — workers idle through both
        if tr is not None:
            tr.record(obs_trace.BARRIER, t0, (t0 := tr.now()), 1)
        if wid == 0:
            fused_sync_sgd_update(v.center, v.master_vel, row, P, e.eta, e.mu)
            ctx.fence()
            ctx.iters.value += P * tau
            if tr is not None:
                tr.record(obs_trace.UPDATE, t0, (t0 := tr.now()))
        ctx.barrier.wait()                   # C — W̄ updated
        if tr is not None:
            tr.record(obs_trace.BARRIER, t0, tr.now(), 2)
        w.copy_(v.center)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def run_ps(problem, easgd: EASGDConfig, cfg: PSConfig, device=None,
           join_timeout_s: float = 600.0) -> PSResult:
    """Run one algorithm for real on ``device`` (default: the card).
    ``problem`` is a ``ProblemSpec`` or, on the thread transport only, a
    prebuilt ``(w0, grad_fn, eval_fn)`` triple whose rows live there."""
    dev = resolve_device(device)
    tr = get_transport(cfg.transport, dev)
    if hasattr(tr, "run"):
        # the network transport owns the whole run (no shared buffers to
        # hand out): net.server's master returns the same PSResult
        return tr.run(problem, easgd, cfg, join_timeout_s=join_timeout_s)
    built = problem.build(dev) if hasattr(problem, "build") else problem
    w0, grad_fn, eval_fn = built
    if cfg.trace:
        obs_trace.drain()                    # a clean registry for this run
        if tr.name == "process" and not cfg.trace_dir:
            # worker tracers live in other processes: they spill to disk
            # and the launcher merges the files
            import tempfile
            cfg = dataclasses.replace(
                cfg, trace_dir=tempfile.mkdtemp(prefix="repro-trace-"))
    w0 = w0.to(dev, torch.float64)
    n, P = w0.numel(), cfg.n_workers
    sync = cfg.algorithm in SYNC
    sched_name = cfg.resolved_schedule(n * 8)
    rounds = (comm_schedules.get(sched_name).rounds(
        P, n * 8, cfg.net, topology=cfg.topology) if sync else [])
    padded = n + (-n) % P

    shapes = {"center": (n,), "center_alt": (n,), "master_vel": (n,),
              "workers_w": (P, n), "workers_v": (P, n),
              "mailbox": (P + 1, padded)}
    buffers = {k: tr.array(*shape) for k, shape in shapes.items()}
    prims = {
        "master_lock": tr.lock(),
        "barrier": tr.barrier(P + 1),            # workers + comm executor
        "start_barrier": tr.barrier(P + 1),      # workers + launcher
        "turn_cond": tr.condition(),
        "wire_free_at": tr.float_slot(),
        "turn": tr.int_slot(), "iters": tr.int_slot(),
        "sync_rounds": tr.int_slot(), "messages": tr.int_slot(),
        "wire_bytes": tr.int_slot(), "err": tr.int_slot(),
        "count_lock": tr.lock(),                 # Hogwild's counters
    }
    launch_slots = None
    if tr.name == "process":
        launch_slots = {k.__name__: tr.int_slot() for k in kernels.KERNELS}
    bounds = None
    if cfg.bucket_bytes > 0 and sync:
        # layer edges come from the problem when it declares them; uniform
        # slabs otherwise — either way the exchange math is bitwise the same
        bounds = comm_rounds.default_bucket_boundaries(
            getattr(grad_fn, "layer_sizes", None), padded, cfg.bucket_bytes)
    worker_problem = built if tr.name == "thread" else problem
    ctx = PSContext(cfg, easgd, n, buffers, worker_problem, rounds, prims,
                    dev, boundaries=bounds, launch_slots=launch_slots)
    v = ctx.views()
    v.center.copy_(w0)
    v.center_alt.copy_(w0)
    v.workers_w.copy_(w0[None])
    timing.synchronize(dev)          # written before another process reads

    handles = tr.launch(ctx)
    comm_thread = None
    if sync:
        comm_thread = threading.Thread(target=_comm_executor, args=(ctx,),
                                       daemon=True)
        comm_thread.start()

    # watchdog: a process worker dying outside its own handler (a failed
    # spawn import, a crash) must break the barriers instead of hanging
    stop_watch = threading.Event()

    def _watchdog():
        while not stop_watch.is_set():
            if any(getattr(h, "exitcode", None) not in (None, 0)
                   for h in handles):
                ctx.err.value = 1
                ctx.barrier.abort()
                ctx.start_barrier.abort()
                return
            time.sleep(0.05)

    watchdog = threading.Thread(target=_watchdog, daemon=True)
    watchdog.start()

    def _fail(msg):
        stop_watch.set()
        ctx.barrier.abort()
        ctx.start_barrier.abort()
        ok = tr.join(handles, timeout=5.0)
        if comm_thread is not None:
            comm_thread.join(timeout=5.0)
        codes = [getattr(h, "exitcode", None) for h in handles]
        cause = ctx.errors[0] if ctx.errors else None
        raise RuntimeError(f"{msg} (algorithm={cfg.algorithm}, transport="
                           f"{cfg.transport}, device={dev}, joined={ok}, "
                           f"exit codes={codes})") from cause

    try:
        ctx.start_barrier.wait(join_timeout_s)   # workers built and warm
    except threading.BrokenBarrierError:
        _fail("ps workers failed to start")
    t0 = time.perf_counter()
    history, last_eval = [], 0
    deadline = t0 + join_timeout_s
    # live telemetry (obs.live): the shared-memory transports have no
    # per-worker heartbeats, so the poll loop samples aggregate gauges only
    # (store wid −1); per-worker series and straggler detection need the
    # tcp transport's per-worker links
    live = None
    if cfg.telemetry_on:
        from repro_torch.obs import live as obs_live
        live = obs_live.LiveMonitor(
            P, deadline_factor=cfg.straggler_factor,
            hb_interval_s=cfg.hb_interval_s,
            jsonl_path=cfg.telemetry_jsonl,
            meta={"algorithm": cfg.algorithm, "transport": cfg.transport})
        live_period = cfg.telemetry_period_s()
        next_sample = time.monotonic() + live_period

    def _live_gauges():
        el = max(time.perf_counter() - t0, 1e-9)
        return {"iters": ctx.iters.value,
                "rate_ips": round(ctx.iters.value / el, 2),
                "wire_bytes": ctx.wire_bytes.value,
                "messages": ctx.messages.value,
                "sync_rounds": ctx.sync_rounds.value}

    while any(h.is_alive() for h in handles):
        if ctx.err.value:
            break
        it = ctx.iters.value
        if it - last_eval >= cfg.eval_every_iters:
            history.append((time.perf_counter() - t0, it,
                            float(eval_fn(v.center.clone()))))
            last_eval = it
        if live is not None and time.monotonic() >= next_sample:
            live.sample(gauges=_live_gauges())
            next_sample += live_period
        if time.perf_counter() > deadline:
            if live is not None:
                live.close()
            _fail(f"ps run exceeded {join_timeout_s}s")
        time.sleep(1e-3)
    timing.synchronize(dev)                  # the clock covers device work
    total_time = time.perf_counter() - t0
    stop_watch.set()
    ok = tr.join(handles, timeout=5.0)
    if comm_thread is not None:
        comm_thread.join(timeout=5.0)
    if ctx.err.value or not ok or (comm_thread is not None
                                   and comm_thread.is_alive()):
        if live is not None:
            live.close()
        _fail("ps run failed")
    it = ctx.iters.value
    if it - last_eval >= cfg.eval_every_iters:
        # the point of the last eval interval the run crossed, where it
        # ended between two polls (a short run under load can end before
        # the first): stamped at the run's end
        history.append((total_time, it, float(eval_fn(v.center.clone()))))
    if launch_slots is not None:
        kernels.add_launch_counts(
            {k: s.value for k, s in launch_slots.items()})
        if dev.type == "cuda":
            torch.cuda.ipc_collect()     # blocks the workers have released

    n_sync_rounds = -(-cfg.total_iters // (P * max(easgd.tau, 1)))
    if cfg.algorithm == "sync_easgd" and n_sync_rounds % 2 == 1:
        v.center.copy_(v.center_alt)         # final version of the flip
    total_iters = (cfg.total_iters if cfg.algorithm.startswith("hogwild")
                   else ctx.iters.value)
    final = float(eval_fn(v.center.clone()))
    history.append((total_time, total_iters, final))
    counters = {"sync_rounds": ctx.sync_rounds.value,
                "messages": ctx.messages.value,
                "wire_bytes": ctx.wire_bytes.value}
    trace = _collect_local_trace(cfg, tr.name, P) if cfg.trace else None
    health = None
    if live is not None:
        live.sample(gauges=_live_gauges())   # the final sample, at end state
        health = live.health()
        counters["health_events"] = len(health["events"])
        live.close()
    return PSResult(
        algorithm=cfg.algorithm, transport=cfg.transport,
        schedule=sched_name if sync else "master", device=str(dev),
        history=history, total_time_s=total_time, total_iters=total_iters,
        counters=counters, final_metric=final, center=v.center.clone(),
        workers=v.workers_w.clone(), trace=trace, health=health)


def _collect_local_trace(cfg: PSConfig, transport: str, P: int) -> dict:
    """Gather the worker and comm tracers after a thread or process run and
    merge them (offsets are 0: perf_counter is system-wide on one host).
    The thread transport reads the registry; the process transport reads
    the spill files its workers wrote. The comm executor's tracer
    (wid −1) rides as the 'master' plane, where the exchange runs on
    tcp."""
    workers: dict = {}
    master_threads: dict = {}
    for t in obs_trace.drain():
        if t.wid >= 0:
            workers.setdefault(t.wid, {"threads": {}, "dropped": 0})
            workers[t.wid]["threads"][t.name] = t.spans()
            workers[t.wid]["dropped"] += t.dropped
        else:
            master_threads[t.name] = t.spans()
    if transport == "process":
        for wid in range(P):
            path = obs_trace.spill_path(cfg.trace_dir, wid)
            if os.path.exists(path):
                workers[wid] = obs_trace.load_spill(path)
    merged = obs_report.merge_traces(
        workers, {"threads": master_threads} if master_threads else None)
    merged["report"] = obs_report.breakdown(merged)
    return merged


# ---------------------------------------------------------------------------
# DES calibration — so simulated and measured clocks are comparable
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Calibration:
    """Machine constants measured on the run's device, for the DES↔real
    comparison.

    ``t_grad_serial`` — one gradient alone; ``t_grad_concurrent`` — a
    worker's per-gradient wall period when all P workers run at once on
    this transport (on one card the P workers' gradients share it);
    ``t_axpy`` / ``alpha`` — the device-memory 'wire': one ``w += 0.5·src``
    over the row, and a 64-element copy plus a wake-up allowance.
    """

    n: int
    n_workers: int
    transport: str
    t_grad_serial: float
    t_grad_concurrent: float
    t_axpy: float
    alpha: float
    link_alpha: float = 0.0          # tcp: the socket link's measured α–β
    link_beta: float = 0.0           # (net.wire.measure_link)
    profile: Optional[costmodel.LinkProfile] = None   # measured per-link-
    #                                  class α–β (cfg.topology runs only):
    #                                  what comm.choose consumes at build
    #                                  time and WELCOME ships to workers

    def sim_config(self, algorithm: str, schedule: str,
                   eval_every_iters: int = 200, seed: int = 0,
                   net: Optional[costmodel.Network] = None) -> SimConfig:
        """The DES's per-worker compute time depends on the discipline:
        original_easgd serializes the whole pipeline (one worker computes
        at a time, alone); everyone else runs P workers concurrently, each
        delivering a gradient every ``t_grad_concurrent``. Pass ``net`` =
        the run's ``PSConfig.emulate_net`` so both clocks charge the same
        wire; default: the measured device-memory 'network', or under a
        measured profile its topology's intra class — the links a topology
        run paces on (the DES then prices the exchange per link class)."""
        if algorithm == "original_easgd":
            t_compute = self.t_grad_serial
        else:
            t_compute = self.t_grad_concurrent
        topology = self.profile.topology if self.profile else None
        if net is None:
            if topology is not None:
                net = topology.intra
            else:
                net = (costmodel.Network("tcp-link", self.link_alpha,
                                         self.link_beta)
                       if self.transport == "tcp" and self.link_alpha
                       else costmodel.Network("shm", self.alpha,
                                              self.t_axpy / (self.n * 8)))
        return SimConfig(
            n_workers=self.n_workers,
            net=net,
            schedule=schedule,
            t_compute=t_compute,
            compute_jitter=0.0,
            t_update_per_byte=self.t_axpy / (self.n * 8),
            eval_every_iters=eval_every_iters,
            seed=seed,
            topology=topology)


def _tcp_concurrent_rate(problem, P: int, samples: int, device) -> float:
    """Median per-gradient wall period across P tcp worker interpreters
    burning at once (``python -m repro_torch.net.worker --burn``): the
    tcp transport's own substrate. The stdin gate keeps interpreter
    start-up, the problem's build and the warm-up off the clock."""
    import json
    import subprocess
    import sys

    from repro_torch.net.server import worker_env
    env = worker_env()
    env.setdefault("OMP_NUM_THREADS",
                   str(max(1, (os.cpu_count() or 1) // (P + 1))))
    spec_json = json.dumps({"factory": problem.factory,
                            "kwargs": list(problem.kwargs)})
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.net.worker", "--wid", str(i),
         "--burn", spec_json, "--samples", str(samples),
         "--device", str(device)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, env=env)
        for i in range(P)]
    try:
        for pr in procs:
            if pr.stdout.readline().strip() != "R":    # built and warm
                raise RuntimeError(
                    f"calibration burner exited {pr.wait()} before READY")
        for pr in procs:
            pr.stdin.write("go\n")
            pr.stdin.flush()
        periods = [float(pr.stdout.readline()) for pr in procs]
    finally:
        for pr in procs:
            pr.stdin.close()
            pr.wait()
    return statistics.median(periods)


def _process_burner(problem, samples, wid, gate, device, period):
    """Module-level so spawn can pickle it (process calibration): after
    the gate, time this process's own gradients into ``period`` (the
    interpreter's teardown stays off the clock)."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
    w0, grad_fn, _ = problem.build(device)
    w = w0.to(device, torch.float64).clone()
    for k in range(5):                       # warm-up: imports, caches
        grad_fn(w, k, -(wid + 2))
    timing.synchronize(device)
    gate.wait()
    with timing.Timer(device) as tm:
        for k in range(samples):
            grad_fn(w, k, -(wid + 2))
    period.value = tm.elapsed / samples


def calibrate(problem, cfg: PSConfig, samples: int = 10,
              device=None) -> Calibration:
    """Measure the run's device. Calibration gradients use worker ids ≤ −1
    (private minibatch streams), so a later run's streams are untouched;
    every clock read follows a device synchronise."""
    dev = resolve_device(device)
    built = problem.build(dev) if hasattr(problem, "build") else problem
    w0, grad_fn, _ = built
    w = w0.to(dev, torch.float64).clone()
    n, P = w.numel(), cfg.n_workers
    grad_fn(w, 0, -1)                        # warm-up
    with timing.Timer(dev) as tm:
        for k in range(samples):
            grad_fn(w, k, -1)
    t_serial = tm.elapsed / samples

    if cfg.transport == "thread":
        def _burn(wid):
            wl = w.clone()
            for k in range(samples):
                grad_fn(wl, k, -(wid + 2))
        ths = [threading.Thread(target=_burn, args=(i,)) for i in range(P)]
        with timing.Timer(dev) as tm:
            for th in ths:
                th.start()
            for th in ths:
                th.join()
        t_concurrent = tm.elapsed / samples
    elif cfg.transport == "tcp":
        # the tcp workers are fresh interpreters: time exactly those
        t_concurrent = _tcp_concurrent_rate(problem, P, samples, dev)
    else:
        # real processes from a gate: spawn and imports off the clock
        mp = torch.multiprocessing.get_context("spawn")
        gate = mp.Barrier(P + 1)
        periods = [mp.RawValue("d", 0.0) for _ in range(P)]
        procs = [mp.Process(target=_process_burner,
                            args=(problem, samples, i, gate, dev,
                                  periods[i]),
                            daemon=True)
                 for i in range(P)]
        for pr in procs:
            pr.start()
        gate.wait()
        for pr in procs:
            pr.join()
        if any(pr.exitcode != 0 for pr in procs):
            raise RuntimeError(f"calibration burners failed: exit codes "
                               f"{[pr.exitcode for pr in procs]}")
        t_concurrent = statistics.median(p.value for p in periods)

    big = torch.zeros(n, dtype=torch.float64, device=dev)
    src = torch.ones(n, dtype=torch.float64, device=dev)
    with timing.Timer(dev) as tm:
        for _ in range(10):
            big += 0.5 * src
    t_axpy = tm.elapsed / 10
    tiny_dst = torch.zeros(64, dtype=torch.float64, device=dev)
    tiny_src = torch.ones(64, dtype=torch.float64, device=dev)
    with timing.Timer(dev) as tm:
        for _ in range(100):
            tiny_dst.copy_(tiny_src)
    alpha = tm.elapsed / 100 + 15e-6         # + wake-up allowance
    link_alpha = link_beta = 0.0
    if cfg.transport == "tcp":
        # the socket link's own α–β, measured through the wire's framing:
        # what the DES charges when no wire is emulated
        from repro_torch.net.wire import measure_link
        link_alpha, link_beta = measure_link(cfg.tcp_host)
    profile = None
    if cfg.topology is not None:
        profile = measured_link_profile(
            cfg, base=(link_alpha, link_beta) if link_alpha else None,
            device=dev)
    return Calibration(n=n, n_workers=P, transport=cfg.transport,
                       t_grad_serial=t_serial, t_grad_concurrent=t_concurrent,
                       t_axpy=t_axpy, alpha=alpha, link_alpha=link_alpha,
                       link_beta=link_beta, profile=profile)


def measured_link_profile(cfg: PSConfig, counters=None,
                          base: Optional[tuple] = None,
                          device=None) -> costmodel.LinkProfile:
    """A per-link-class α–β profile learned on the live machinery.

    The physical floor: for tcp a short burst through the real framing
    (``net.wire.measure_link``), for the thread plane a timed copy in the
    run's device memory (its wire). A run's ``counters['link_alpha_s']``
    (clock-probe rtt / 2 per master link) overrides the floor's α when
    given; ``base`` is an already-measured (α, β) pair. The floor adds to
    the topology's declared classes: pacing sleeps ride on top of the real
    transfer."""
    topo = cfg.topology
    if topo is None:
        raise ValueError("measured_link_profile needs cfg.topology")
    detail: dict = {}
    if base is not None:
        alpha0, beta0 = base
        source = f"measured:{cfg.transport}"
    elif cfg.transport == "tcp":
        from repro_torch.net.wire import measure_link
        alpha0, beta0 = measure_link(cfg.tcp_host, reps=12,
                                     big_bytes=1_000_000)
        source = "measured:tcp"
    else:
        dev = resolve_device(device)
        buf = torch.zeros(1 << 17, dtype=torch.float64, device=dev)
        src = torch.ones(1 << 17, dtype=torch.float64, device=dev)
        buf.copy_(src)                            # warm
        with timing.Timer(dev) as tm:
            for _ in range(8):
                buf.copy_(src)
        beta0 = tm.elapsed / 8 / (buf.numel() * 8)
        tiny_d = torch.zeros(64, dtype=torch.float64, device=dev)
        tiny_s = torch.ones(64, dtype=torch.float64, device=dev)
        with timing.Timer(dev) as tm:
            for _ in range(100):
                tiny_d.copy_(tiny_s)
        alpha0 = tm.elapsed / 100
        source = "measured:thread"
    detail["alpha0_s"] = float(alpha0)
    detail["beta0_s_per_byte"] = float(beta0)
    probes = (counters or {}).get("link_alpha_s")
    if isinstance(probes, dict) and probes:
        vals = sorted(probes.values())
        alpha0 = float(vals[len(vals) // 2])
        detail["alpha0_s"] = alpha0
        detail["alpha0_source"] = "clock-probe rtt/2 median"
    intra = costmodel.Network(f"{topo.intra.name} +measured",
                              topo.intra.alpha + alpha0,
                              topo.intra.beta + beta0)
    cross = (intra if topo.cross == topo.intra else
             costmodel.Network(f"{topo.cross.name} +measured",
                               topo.cross.alpha + alpha0,
                               topo.cross.beta + beta0))
    measured = costmodel.Topology(hosts=topo.hosts, slots=topo.slots,
                                  intra=intra, cross=cross)
    return costmodel.LinkProfile(topology=measured, source=source,
                                 detail=detail)


def calibrate_sim(problem, cfg: PSConfig, samples: int = 10,
                  eval_every_iters: Optional[int] = None,
                  device=None) -> SimConfig:
    """``calibrate`` + ``sim_config`` for cfg's own algorithm and
    schedule."""
    cal = calibrate(problem, cfg, samples=samples, device=device)
    return cal.sim_config(
        cfg.algorithm, cfg.resolved_schedule(cal.n * 8, profile=cal.profile),
        eval_every_iters=eval_every_iters or cfg.eval_every_iters,
        seed=cfg.seed)


def run_vs_des(problem, easgd: EASGDConfig, cfg: PSConfig,
               cal: Optional[Calibration] = None, device=None) -> tuple:
    """The measured-vs-simulated comparison: run ``cfg`` for real and
    through the DES calibrated on the same device, charging the DES the
    run's own emulated wire. Returns ``(PSResult, RunResult, record)``;
    ``record`` is the flat JSON-ready comparison."""
    dev = resolve_device(device)
    if cal is None:
        cal = calibrate(problem, cfg, device=dev)
    built = problem.build(dev) if hasattr(problem, "build") else problem
    w0, grad_fn, eval_fn = built
    sched_name = cfg.resolved_schedule(cal.n * 8, profile=cal.profile)
    sim = cal.sim_config(
        cfg.algorithm, sched_name,
        eval_every_iters=cfg.eval_every_iters, seed=cfg.seed,
        net=cfg.emulate_net)
    des = PSEngine(grad_fn, eval_fn, w0, easgd, sim).run(
        cfg.algorithm, total_iters=cfg.total_iters)
    if cal.profile is not None and cfg.link_profile is None:
        # the run consumes the profile the choice and the DES priced
        cfg = dataclasses.replace(cfg, link_profile=cal.profile)
    res = run_ps(problem, easgd, cfg, device=dev)
    meas = res.total_time_s / max(res.total_iters, 1)
    pred = des.total_time_s / max(des.total_iters, 1)
    record = {
        "algorithm": cfg.algorithm,
        "transport": cfg.transport,
        "schedule": res.schedule,
        "device": res.device,
        "iters": res.total_iters,
        "measured_us_per_iter": 1e6 * meas,
        "des_us_per_iter": 1e6 * pred,
        "measured_over_des": meas / pred,
        "iters_per_sec": 1.0 / meas,
        "final_err": res.final_metric,
        "counters": res.counters,
        "curve_real": [(round(t, 4), it, e) for t, it, e in res.history],
        "curve_des": [(round(t, 4), it, e) for t, it, e in des.history],
    }
    if cal.profile is not None:
        record["profile_source"] = cal.profile.source
        record["profile_detail"] = dict(cal.profile.detail)
    return res, des, record


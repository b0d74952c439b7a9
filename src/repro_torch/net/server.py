"""The tcp transport's master: the PS runtime's disciplines served over
TCP links instead of shared memory (the port of ``repro/net/server.py``).

The state layout is the thread transport's (center, per-worker weights and
velocities, the padded all-reduce mailbox), on the run's device (the card
by default); what changes is who moves the bytes. Every exchange is an
explicit frame on a link, so the master owns all optimizer state and the
workers hold only what they need to compute gradients:

 * ``original_easgd`` — one worker at a time end to end (WEIGHTS go out
   only when its turn comes): the Θ(P) serialization is the wire's;
 * async FCFS — GRAD frames absorbed in arrival order; with
   ``deterministic=True`` in strict cyclic order, the DES zero-jitter
   event order, which makes tcp and thread weights bitwise equal;
 * hogwild — absorb on arrival with no admission discipline;
 * sync family — per round the master distributes WEIGHTS, runs the
   schedule's rounds over its mailbox (``comm.rounds.execute_rounds``, the
   thread transport's executor) while the workers compute, then applies
   the updates through the fused kernels (``kernels.elastic_update``):
   one Sync EASGD launch per worker, rank 0's also writing the new center
   into the other center buffer; one Sync SGD launch per round. Under
   ``sync_plane="p2p"`` the workers execute the rounds over direct
   worker↔worker links (``net.peer``) and the master is a control plane:
   its links carry worker 0's CENTER reports and one final WSTATE each.

Frames in and out of the master go through pinned host buffers
(``wire.HostRow``), one per link and direction: a reader thread receives
a worker's GRAD / WSTATE into its buffer, the serve loop copies it to the
device before it sends that worker anything again, so the buffer is never
overwritten early.

Wire emulation (``PSConfig.emulate_net``) composes with the real socket:
deadlines are taken before a transfer and slept to after it.

Worker processes run ``python -m repro_torch.net.worker`` on the run's
device; their kernel launch counts come home in BYE and are added to this
process's (``kernels.add_launch_counts``).
"""
from __future__ import annotations

import heapq
import json
import os
import queue
import socket
import subprocess
import sys
import threading
import time

import torch

from repro_torch import kernels
from repro_torch.comm import rounds as comm_rounds
from repro_torch.comm import schedules as comm_schedules
from repro_torch.comm.rounds import execute_rounds
from repro_torch.core import easgd_flat
from repro_torch.core.compression import sign_ef_wire_nbytes
from repro_torch.kernels.elastic_update import (fused_sync_easgd_update,
                                                fused_sync_sgd_update)
from repro_torch.net import wire
from repro_torch.net.wire import HostRow, Link, sleep_until
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import report as obs_report
from repro_torch.obs import trace as obs_trace
from repro_torch.utils.device import resolve_device
from repro_torch.utils.timing import stream_sync

SYNC = easgd_flat.SYNC_FAMILY
DEFAULT_TOKEN = "repro-net"
SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def wire_payload_nbytes(n_elements: int, codec: str) -> int:
    """Exact framed payload size of one n-element array message."""
    if codec == "sign_ef":
        return sign_ef_wire_nbytes(n_elements)
    return n_elements * 8


def worker_env() -> dict:
    """Environment of a spawned worker interpreter: this checkout's src
    directory on PYTHONPATH."""
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    return env


def cluster_spec_env(role: str, wid: int, host: str, port: int,
                     token: str = DEFAULT_TOKEN,
                     sync_plane: str | None = None,
                     peer_port: int | None = None) -> str:
    """The ``REPRO_CLUSTER_SPEC`` JSON that names one worker's run: the
    worker CLI fills any connection detail its command line leaves out
    from it."""
    spec = {"role": role, "wid": wid, "host": host, "port": int(port),
            "token": token}
    if sync_plane is not None:
        spec["sync_plane"] = sync_plane
    if peer_port is not None:
        spec["peer_port"] = int(peer_port)
    return json.dumps(spec)


def spawn_local_workers(host: str, port: int, n_workers: int, device,
                        token: str = DEFAULT_TOKEN) -> list:
    """Start ``n_workers`` localhost worker interpreters on ``device``.
    Unless the environment says otherwise, each gets an equal share of the
    host's cores for its CPU thread pools (``OMP_NUM_THREADS``, as
    ``torchrun`` does): P interpreters each spinning a pool the size of the
    host oversubscribe it many times over."""
    base = worker_env()
    base.setdefault("OMP_NUM_THREADS",
                    str(max(1, (os.cpu_count() or 1) // (n_workers + 1))))
    procs = []
    for i in range(n_workers):
        env = dict(base)
        env["REPRO_CLUSTER_SPEC"] = cluster_spec_env("worker", i, host, port,
                                                     token)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.net.worker",
             "--connect", f"{host}:{port}", "--wid", str(i),
             "--token", token, "--device", str(device)],
            env=env))
    return procs


def worker_command(addr: str, wid: int, token: str = DEFAULT_TOKEN,
                   sync_plane: str | None = None,
                   peer_port: int | None = None, device=None) -> str:
    """The shell line a remote host runs to join this master. For a p2p
    run it pins the worker's peer-listener port and names the plane, so
    the line is launchable verbatim."""
    cmd = (f"PYTHONPATH=src python -m repro_torch.net.worker "
           f"--connect {addr} --wid {wid} --token {token}")
    if device is not None:
        cmd += f" --device {device}"
    if sync_plane is not None:
        cmd += f" --sync-plane {sync_plane}"
    if peer_port is not None:
        cmd += f" --peer-port {peer_port}"
    return cmd


def accept_backlog(n_workers: int) -> int:
    """Rendezvous ``listen()`` backlog: every worker dials in the same
    burst."""
    return max(16, n_workers + 8)


class MasterServer:
    """One training run: rendezvous P links, run the discipline, shut
    down."""

    def __init__(self, problem, easgd, cfg, device=None,
                 join_timeout_s: float = 600.0):
        if not hasattr(problem, "build"):
            raise ValueError(
                "tcp transport needs a ProblemSpec (module:function) — "
                "remote workers rebuild the problem from its factory")
        if cfg.deterministic and cfg.wire_compression != "none":
            raise ValueError(
                "deterministic admission is the bitwise DES/thread "
                "cross-check mode; lossy wire compression "
                f"('{cfg.wire_compression}') would break it — run one or "
                "the other")
        self.problem = problem
        self.easgd = easgd
        self.cfg = cfg
        self.timeout = join_timeout_s
        dev = self.device = resolve_device(device)
        w0, grad_fn, self.eval_fn = problem.build(dev)
        self.w0 = w0.to(dev, torch.float64)
        self.n = n = self.w0.numel()
        P = cfg.n_workers
        self.tau = max(int(easgd.tau), 1)
        self.sched_name = cfg.resolved_schedule(n * 8)
        self.rounds = (comm_schedules.get(self.sched_name)
                       .rounds(P, n * 8, cfg.net)
                       if cfg.algorithm in SYNC else [])
        self.sync_p2p = cfg.algorithm in SYNC and cfg.sync_plane == "p2p"
        if self.sync_p2p and any(
                m.src == comm_rounds.MASTER or m.dst == comm_rounds.MASTER
                for rnd in self.rounds for m in rnd):
            raise ValueError(
                f"schedule '{self.sched_name}' routes through the master "
                f"endpoint — it is the master plane; pick a peer schedule "
                f"(ring/tree/butterfly/hierarchical) for sync_plane='p2p'")
        self.padded = padded = n + (-n) % P
        self.boundaries = None
        if cfg.bucket_bytes > 0 and cfg.algorithm in SYNC:
            self.boundaries = comm_rounds.default_bucket_boundaries(
                getattr(grad_fn, "layer_sizes", None), padded,
                cfg.bucket_bytes)

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float64, device=dev)

        # -- master-owned optimizer state (the thread transport's layout) --
        self.center = self.w0.clone()
        self.center_alt = self.w0.clone()    # Sync EASGD's other version
        self.master_vel = zeros(n)
        self.workers_w = self.w0[None].repeat(P, 1)
        self.workers_v = zeros(P, n)
        self.mailbox = zeros(P + 1, padded)
        self.grads = zeros(P, n)
        # -- wiring: master_link_bytes counts only frames on the master's
        #    own links (wire_bytes also takes the centralized rounds) --------
        self.counters = obs_metrics.Registry()
        for name in ("sync_rounds", "messages", "wire_bytes",
                     "master_link_bytes"):
            self.counters.counter(name)
        self.link_counters = {"messages": self.counters["messages"],
                              "wire_bytes": self.counters["wire_bytes"],
                              "link_bytes": self.counters["master_link_bytes"]}
        if cfg.trace:
            obs_trace.drain()                # clean registry for this run
        self.tracer = (obs_trace.tracer("serve", sync=stream_sync(dev))
                       if cfg.trace else None)
        self.links: dict[int, Link] = {}
        self.peer_addrs: dict[int, list] = {}
        self.bye_stats: dict[int, dict] = {}
        self.events: queue.Queue = queue.Queue()
        # host staging, one buffer per link and direction
        self.up_host = [HostRow(self._up_elems(), dev) for _ in range(P)]
        self.wstate_host = [HostRow(n, dev) for _ in range(P)]
        self.down_host = ([HostRow(self._down_elems(), dev)
                           for _ in range(P)] if not self.sync_p2p else [])
        self.iters = 0
        self.history: list = []
        self._last_eval = 0
        self._t0 = 0.0
        self._closing = threading.Event()
        self._threads: list = []
        self._procs: list = []
        self._spawned_at = time.monotonic()
        self.ready_s: dict[int, float] = {}  # spawn → READY, per worker
        self._draining = False           # True once DONE went out

    # -- payload shapes ------------------------------------------------------

    def _up_elems(self) -> int:
        """Elements of one GRAD frame: with τ > 1 the async families stack
        [grad|w] (+[v] for the velocity rules)."""
        if self.tau == 1 or self.cfg.algorithm in SYNC:
            return self.n
        k = 3 if easgd_flat.uses_velocity(self.cfg.algorithm) else 2
        return k * self.n

    @property
    def _down_stacked(self) -> bool:
        """τ > 1 velocity rules evolve V locally, so WEIGHTS carry [w|v]."""
        return (self.tau > 1 and self.cfg.algorithm not in SYNC
                and easgd_flat.uses_velocity(self.cfg.algorithm))

    def _down_elems(self) -> int:
        return 2 * self.n if self._down_stacked else self.n

    def _absorb_upload(self, wid: int) -> torch.Tensor:
        """Copy worker ``wid``'s GRAD frame to the device — a τ > 1 upload
        also refreshes the master's copy of its (w, v) — and return the
        gradient."""
        rows = [self.grads[wid]]
        k = self._up_elems() // self.n
        if k >= 2:
            rows.append(self.workers_w[wid])
        if k == 3:
            rows.append(self.workers_v[wid])
        self.up_host[wid].get(*rows)
        return self.grads[wid]

    # -- pacing --------------------------------------------------------------

    def _t_msg_pair(self) -> tuple:
        """(t_down, t_up) emulated per-message times of the post-codec
        payloads."""
        codec = self.cfg.wire_compression
        return (self.cfg.t_msg_emulated(
                    wire_payload_nbytes(self._down_elems(), codec)),
                self.cfg.t_msg_emulated(
                    wire_payload_nbytes(self._up_elems(), codec)))

    def _n_sync_rounds(self) -> int:
        return -(-self.cfg.total_iters // (self.cfg.n_workers * self.tau))

    def _t_sync_wire(self) -> float:
        """Emulated time of one exchange: the rounds serialize, each
        costs α + max_frac·n·β."""
        return sum(
            self.cfg.t_msg_emulated(max(m.frac for m in rnd) * self.n * 8)
            for rnd in self.rounds)

    def _t_sync_wire_buckets(self) -> list:
        """Per-bucket emulated wire time of the bucketed view."""
        if self.cfg.emulate_net is None:
            return [0.0] * (len(self.boundaries) - 1)
        return comm_rounds.t_rounds_buckets(self.rounds, self.padded,
                                            self.boundaries,
                                            self.cfg.emulate_net)

    def _eval_rounds(self) -> list:
        """Exchange rounds after which the eval cadence fires — the
        ``_maybe_eval`` trigger precomputed, so the p2p workers and this
        master agree when worker 0 reports its CENTER."""
        evals, last = [], 0
        per = self.cfg.n_workers * self.tau
        for k in range(self._n_sync_rounds()):
            if (k + 1) * per - last >= self.cfg.eval_every_iters:
                evals.append(k)
                last = (k + 1) * per
        return evals

    # -- lifecycle -----------------------------------------------------------

    def _welcome_payload(self, wid: int) -> dict:
        cfg, e = self.cfg, self.easgd
        welcome = {
            "wid": wid,
            "factory": self.problem.factory,
            "kwargs": list(self.problem.kwargs),
            "algorithm": cfg.algorithm,
            "n": self.n,
            "tau": self.tau,
            "eta": e.eta, "mu": e.mu, "rho": e.rho,
            "codec": cfg.wire_compression,
            "warmup": 2,
            "hb_interval_s": cfg.hb_interval_s,
            "trace": bool(cfg.trace),
            "trace_dir": cfg.trace_dir,
        }
        if self.sync_p2p:
            welcome.update({
                "sync_plane": "p2p",
                "p": cfg.n_workers,
                "padded": self.padded,
                "rounds": comm_rounds.rounds_to_wire(self.rounds),
                "n_rounds": self._n_sync_rounds(),
                "eval_rounds": self._eval_rounds(),
                "t_wire_s": self._t_sync_wire(),
                "peers": {str(w): a for w, a in self.peer_addrs.items()},
                "bucket_bounds": self.boundaries,
                "overlap": cfg.overlap,
                "t_wire_bucket_s": (self._t_sync_wire_buckets()
                                    if self.boundaries else []),
            })
        return welcome

    def rendezvous(self, listener: socket.socket, token: str) -> None:
        """Accept until every wid 0..P−1 said HELLO, send WELCOME, wait for
        every READY (problem built, warmed up)."""
        cfg, P = self.cfg, self.cfg.n_workers
        deadline = time.monotonic() + self.timeout
        listener.settimeout(1.0)
        while len(self.links) < P:
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"rendezvous timeout: {len(self.links)}/{P} workers "
                    f"connected (algorithm={cfg.algorithm})")
            self._check_procs()
            try:
                conn, _ = listener.accept()
            except socket.timeout:
                continue
            conn.settimeout(30.0)       # a connected-but-silent client must
            link = Link(conn, codec=cfg.wire_compression,   # not stall HELLO
                        counters=self.link_counters)
            try:
                frame = link.recv_header()
            except (socket.timeout, wire.WireError, OSError):
                link.close()
                continue
            if frame.ftype != wire.HELLO:
                link.close()
                continue
            hello = link.recv_json(frame)
            if hello.get("token") != token:
                link.send_json(wire.ERROR, {"msg": "bad token"})
                link.close()
                continue
            wid = int(hello["wid"])
            if not (0 <= wid < P) or wid in self.links:
                link.send_json(wire.ERROR, {"msg": f"bad wid {wid}"})
                link.close()
                continue
            if "peer" in hello:
                self.peer_addrs[wid] = list(hello["peer"])
            self.links[wid] = link
        if self.sync_p2p:
            missing = [w for w in self.links if w not in self.peer_addrs]
            if missing:
                for link in self.links.values():
                    link.send_json(wire.ERROR, {
                        "msg": f"sync_plane=p2p but worker(s) {missing} "
                               f"advertised no peer listener "
                               f"(started with --sync-plane master?)"})
                raise RuntimeError(
                    f"p2p rendezvous failed: worker(s) {missing} advertised "
                    f"no peer listener")
        for wid, link in self.links.items():
            link.send_json(wire.WELCOME, self._welcome_payload(wid))
        for wid, link in self.links.items():
            self._threads.append(threading.Thread(
                target=self._reader, args=(wid, link), daemon=True))
            self._threads[-1].start()
        ready = set()
        while len(ready) < P:
            wid, kind, detail = self._next_event(deadline - time.monotonic())
            if kind != "ready":
                raise RuntimeError(
                    f"worker {wid} failed during rendezvous: {kind} {detail}")
            ready.add(wid)
            self.ready_s[wid] = round(time.monotonic() - self._spawned_at, 3)

    def _reader(self, wid: int, link: Link) -> None:
        """Per-link reader: frames into the worker's host buffers, then an
        event. One outstanding exchange per worker by protocol, so a
        buffer is copied out before the worker can send into it again."""
        try:
            while True:
                frame = link.recv_header()
                if frame.ftype == wire.GRAD:
                    link.recv_array(frame, self.up_host[wid].np)
                    self.events.put((wid, "grad", None))
                elif frame.ftype == wire.WSTATE:
                    link.recv_array(frame, self.wstate_host[wid].np)
                    self.events.put((wid, "wstate", None))
                elif frame.ftype == wire.CENTER:
                    # the header's wid field carries the report tag (eval
                    # round ≥ 0, −1 final); a fresh array keeps a slow eval
                    # from racing the next report
                    self.events.put((wid, "center",
                                     (frame.wid,
                                      link.recv_array(frame).copy())))
                elif frame.ftype == wire.READY:
                    link.recv_discard(frame)
                    self.events.put((wid, "ready", None))
                elif frame.ftype == wire.CLOCK:
                    # NTP-style probe: echo this clock at once, on the
                    # reader thread, so serve() never delays a probe
                    link.recv_discard(frame)
                    link.send_json(wire.CLOCK,
                                   {"t": time.perf_counter()}, wid=wid)
                elif frame.ftype == wire.BYE:
                    if frame.size:
                        self.bye_stats[wid] = link.recv_json(frame)
                    else:
                        link.recv_discard(frame)
                    self.events.put((wid, "bye", None))
                    return
                elif frame.ftype == wire.ERROR:
                    msg = link.recv_json(frame)
                    self.events.put((wid, "error", msg.get("msg", "?")))
                    return
                else:
                    link.recv_discard(frame)
        except (wire.WireError, OSError) as exc:
            if not self._closing.is_set():
                self.events.put((wid, "dead", repr(exc)))

    def _check_procs(self) -> None:
        for proc in self._procs:
            rc = proc.poll()
            if rc not in (None, 0):
                raise RuntimeError(
                    f"tcp worker process exited with code {rc} "
                    f"(algorithm={self.cfg.algorithm})")

    def _next_event(self, timeout: float):
        """Pop one event; worker failures and heartbeat silence raise
        instead of hanging the launcher."""
        deadline = time.monotonic() + max(timeout, 0.0)
        while True:
            self._check_procs()
            if self.links:
                worst = max(time.monotonic() - l.last_seen
                            for l in self.links.values())
                cell = self.counters.gauge("hb_staleness_max_s")
                cell.value = max(cell.value, round(worst, 3))
            stale = [w for w, l in self.links.items()
                     if time.monotonic() - l.last_seen > self.cfg.hb_timeout_s]
            if stale:
                raise RuntimeError(
                    f"worker(s) {stale} silent for more than "
                    f"{self.cfg.hb_timeout_s}s (heartbeats stopped)")
            try:
                wid, kind, detail = self.events.get(timeout=0.5)
            except queue.Empty:
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"timed out waiting for workers "
                        f"(algorithm={self.cfg.algorithm})") from None
                continue
            if kind in ("error", "dead"):
                raise RuntimeError(f"worker {wid} failed: {detail}")
            if kind == "bye" and not self._draining:
                raise RuntimeError(
                    f"worker {wid} left the run (clean BYE mid-run)")
            return wid, kind, detail

    def _await(self, kind: str, need: set, ignore: tuple = ()) -> None:
        """Block until every wid in ``need`` delivered one ``kind`` event;
        ``ignore`` skips exchanges still in flight when DONE went out."""
        pending = set(need)
        while pending:
            wid, got, _ = self._next_event(self.timeout)
            if got in ignore:
                continue
            if got != kind:
                raise RuntimeError(
                    f"protocol violation: expected {kind} from {pending}, "
                    f"got {got} from worker {wid}")
            pending.discard(wid)

    # -- eval ----------------------------------------------------------------

    def _maybe_eval(self, force: bool = False) -> None:
        if force or self.iters - self._last_eval >= self.cfg.eval_every_iters:
            t0 = time.perf_counter()
            self.history.append((t0 - self._t0, self.iters,
                                 float(self.eval_fn(self.center.clone()))))
            self._last_eval = self.iters
            if self.tracer is not None:
                self.tracer.record(obs_trace.EVAL, t0, self.tracer.now())

    # -- disciplines ---------------------------------------------------------

    def _send_weights(self, wid: int) -> int:
        down = self.down_host[wid]
        if self._down_stacked:
            return self.links[wid].send_array(
                wire.WEIGHTS, down.put(self.workers_w[wid],
                                       self.workers_v[wid]),
                wid=wid, segments=2)
        return self.links[wid].send_array(
            wire.WEIGHTS, down.put(self.workers_w[wid]), wid=wid)

    def serve(self) -> None:
        algo = self.cfg.algorithm
        self._t0 = time.perf_counter()
        if self.sync_p2p:
            self._serve_sync_p2p()
        elif algo in SYNC:
            self._serve_sync()
        elif algo == "original_easgd":
            self._serve_original()
        elif self.cfg.deterministic:
            self._serve_turnstile()
        elif algo.startswith("hogwild"):
            self._serve_hogwild()
        else:
            self._serve_fcfs()

    def _serve_original(self) -> None:
        """Round robin with compute in the turn: WEIGHTS go out only when
        the turn arrives, so the wire serializes the whole pipeline."""
        e, cfg = self.easgd, self.cfg
        P = cfg.n_workers
        n_turns = -(-cfg.total_iters // self.tau)
        t_down, t_up = self._t_msg_pair()
        for turn in range(n_turns):
            j = turn % P
            deadline = time.monotonic() + t_down
            self._send_weights(j)
            if t_down:
                sleep_until(deadline)            # W̄ down
            self._await("grad", {j})
            grad = self._absorb_upload(j)
            deadline = time.monotonic() + t_up
            easgd_flat.master_absorb_round_robin(
                self.center, self.workers_w[j], self.workers_v[j], grad, e)
            if t_up:
                sleep_until(deadline)            # W⁽ʲ⁾ up
            self.iters += self.tau
            self._maybe_eval()

    def _serve_turnstile(self) -> None:
        """Deterministic admission: every worker computes ahead, the master
        absorbs in strict cyclic order — the DES zero-jitter event order,
        hence the thread transport's bits."""
        e, cfg = self.easgd, self.cfg
        ready = [False] * cfg.n_workers
        for wid in self.links:
            self._send_weights(wid)
        t_pair = sum(self._t_msg_pair())
        turn = 0
        while self.iters < cfg.total_iters:
            j = turn % cfg.n_workers
            while not ready[j]:
                wid, kind, _ = self._next_event(self.timeout)
                if kind != "grad":
                    raise RuntimeError(f"expected a grad, got {kind}")
                ready[wid] = True
            ready[j] = False
            deadline = time.monotonic() + t_pair
            grad = self._absorb_upload(j)
            easgd_flat.master_absorb(
                cfg.algorithm, self.center, self.master_vel,
                self.workers_w[j], self.workers_v[j], grad, e)
            if t_pair:
                sleep_until(deadline)
            turn += 1
            self.iters += self.tau
            self._maybe_eval()
            if self.iters < cfg.total_iters:
                self._send_weights(j)

    def _serve_fcfs(self) -> None:
        """Async family: absorb in arrival order; the one master wire
        serializes both messages of each exchange."""
        e, cfg = self.easgd, self.cfg
        wire_free_at = 0.0
        t_pair = sum(self._t_msg_pair())
        for wid in self.links:
            self._send_weights(wid)
        while self.iters < cfg.total_iters:
            j, kind, _ = self._next_event(self.timeout)
            if kind != "grad":
                raise RuntimeError(f"expected a grad, got {kind}")
            deadline = None
            if t_pair:
                start = max(time.monotonic(), wire_free_at)
                deadline = start + t_pair
                wire_free_at = deadline
            grad = self._absorb_upload(j)
            easgd_flat.master_absorb(
                cfg.algorithm, self.center, self.master_vel,
                self.workers_w[j], self.workers_v[j], grad, e)
            if deadline is not None:
                sleep_until(deadline)
            self.iters += self.tau
            self._maybe_eval()
            if self.iters < cfg.total_iters:
                self._send_weights(j)

    def _serve_hogwild(self) -> None:
        """Absorb on arrival, no discipline; per-exchange wire times
        overlap — a delayed-sender thread releases each reply at its own
        deadline. Per-worker quotas as on the thread transport."""
        e, cfg = self.easgd, self.cfg
        P, total = cfg.n_workers, cfg.total_iters
        t_pair = sum(self._t_msg_pair())
        quota = [(total // P + (1 if w < total % P else 0)) for w in range(P)]
        target = [-(-q // self.tau) for q in quota]   # exchanges per worker
        done = [0] * P
        replies: queue.Queue = queue.Queue()          # (deadline, wid)
        stop = threading.Event()

        def _delayed_sender():
            pend: list = []
            while not stop.is_set():
                timeout = (max(0.0, min(pend[0][0] - time.monotonic(), 0.2))
                           if pend else 0.2)
                try:
                    heapq.heappush(pend, replies.get(timeout=timeout))
                except queue.Empty:
                    pass
                now = time.monotonic()
                while pend and pend[0][0] <= now:
                    _, w = heapq.heappop(pend)
                    self._send_weights(w)

        sender = threading.Thread(target=_delayed_sender, daemon=True)
        sender.start()
        try:
            for wid in self.links:
                self._send_weights(wid)
            while any(d < t for d, t in zip(done, target)):
                j, kind, _ = self._next_event(self.timeout)
                if kind != "grad":
                    raise RuntimeError(f"expected a grad, got {kind}")
                grad = self._absorb_upload(j)
                deadline = time.monotonic() + t_pair
                easgd_flat.master_absorb(
                    cfg.algorithm, self.center, self.master_vel,
                    self.workers_w[j], self.workers_v[j], grad, e)
                done[j] += 1
                self.iters += self.tau
                self._maybe_eval()
                if done[j] < target[j]:
                    if t_pair:
                        replies.put((deadline, j))
                    else:
                        self._send_weights(j)
        finally:
            stop.set()
            sender.join(timeout=5)
        self.iters = total                            # quota-exact

    def _serve_sync(self) -> None:
        """Barriered rounds over links. Sync EASGD's all-reduce runs on the
        master's mailbox while the workers compute their gradients (the
        §6.1.3 overlap); Sync SGD's must wait for the gradients."""
        e, cfg = self.easgd, self.cfg
        algo, n, P = cfg.algorithm, self.n, cfg.n_workers
        t_wire = self._t_sync_wire()
        tr = self.tracer
        roster = range(P)
        while self.iters < cfg.total_iters:
            for wid in roster:
                self._send_weights(wid)
            if algo == "sync_easgd":
                got_grad: set = set()
                if self.tau > 1:
                    # workers post their evolved weights (WSTATE) before
                    # the exchange gradient; a fast worker's GRAD may
                    # arrive before a slow one's WSTATE
                    got_w: set = set()
                    while len(got_w) < P:
                        wid, kind, _ = self._next_event(self.timeout)
                        if kind == "wstate":
                            self.wstate_host[wid].get(self.workers_w[wid])
                            got_w.add(wid)
                        elif kind == "grad":
                            got_grad.add(wid)
                        else:
                            raise RuntimeError(
                                f"expected a wstate or grad, got {kind}")
                self.mailbox[:P, :n].copy_(self.workers_w)
                deadline = time.monotonic() + t_wire
                if tr is not None:
                    t0 = tr.now()
                execute_rounds(self.mailbox, n, self.rounds, self.counters,
                               boundaries=self.boundaries, tracer=tr)
                if t_wire:
                    sleep_until(deadline)
                if tr is not None:
                    tr.record(obs_trace.EXCHANGE, t0, (t0 := tr.now()))
                self._await("grad", set(roster) - got_grad)
                if tr is not None:
                    tr.record(obs_trace.RECV_WAIT, t0, (t0 := tr.now()))
                row = self.mailbox[0, :n]
                for i in roster:
                    fused_sync_easgd_update(
                        self.workers_w[i], self._absorb_upload(i),
                        self.center, row, P, e.eta, e.rho,
                        center_out=self.center_alt if i == 0 else None)
                self.center, self.center_alt = self.center_alt, self.center
                if tr is not None:
                    tr.record(obs_trace.UPDATE, t0, tr.now())
            else:                                     # sync_sgd
                if tr is not None:
                    t0 = tr.now()
                self._await("grad", set(roster))
                if tr is not None:
                    tr.record(obs_trace.RECV_WAIT, t0, (t0 := tr.now()))
                for i in roster:
                    self.up_host[i].get(self.mailbox[i, :n])
                deadline = time.monotonic() + t_wire
                execute_rounds(self.mailbox, n, self.rounds, self.counters,
                               boundaries=self.boundaries, tracer=tr)
                if t_wire:
                    sleep_until(deadline)
                if tr is not None:
                    tr.record(obs_trace.EXCHANGE, t0, (t0 := tr.now()))
                fused_sync_sgd_update(self.center, self.master_vel,
                                      self.mailbox[0, :n], P, e.eta, e.mu)
                self.workers_w.copy_(self.center[None].expand(P, n))
                if tr is not None:
                    tr.record(obs_trace.UPDATE, t0, tr.now())
            self.iters += P * self.tau
            self._maybe_eval()

    def _serve_sync_p2p(self) -> None:
        """The p2p control plane: the workers run the rounds among
        themselves, so this loop only takes worker 0's CENTER reports
        (tagged with the exchange round) and each worker's final WSTATE."""
        per = self.cfg.n_workers * self.tau
        final_center = False
        wstates: set = set()
        while not (final_center and wstates >= set(self.links)):
            wid, kind, detail = self._next_event(self.timeout)
            if kind == "center":
                tag, arr = detail
                self.center.copy_(torch.from_numpy(arr[:self.n]))
                if tag >= 0:
                    self.iters = (tag + 1) * per
                    self._maybe_eval(force=True)
                else:
                    self.iters = self._n_sync_rounds() * per
                    final_center = True
            elif kind == "wstate":
                self.wstate_host[wid].get(self.workers_w[wid])
                wstates.add(wid)
            else:
                raise RuntimeError(
                    f"protocol violation on the p2p control plane: "
                    f"got {kind} from worker {wid} ({detail!r})")

    # -- top level -----------------------------------------------------------

    def run(self, listener: socket.socket, token: str = DEFAULT_TOKEN,
            procs: list | None = None):
        """Rendezvous → serve → clean shutdown. Returns a PSResult."""
        from repro_torch.ps.runtime import PSResult
        self._procs = procs or []
        try:
            self.rendezvous(listener, token)
            self.serve()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            total_time = time.perf_counter() - self._t0
            self._maybe_eval(force=True)
            self._draining = True        # BYEs are expected from here on
            for link in self.links.values():
                link.send_simple(wire.DONE)
            self._await("bye", set(self.links),
                        ignore=("grad", "wstate", "center"))
        finally:
            self._closing.set()
            for link in self.links.values():
                link.close()
            listener.close()
            for proc in self._procs:
                try:
                    proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
        for st in self.bye_stats.values():
            kernels.add_launch_counts(st.get("launches", {}))
        counters = self.counters.snapshot()
        counters["worker_ready_s"] = dict(sorted(self.ready_s.items()))
        counters["worker_startup_s"] = {
            w: st["startup_s"] for w, st in sorted(self.bye_stats.items())
            if st.get("startup_s")}
        # heartbeat-piggybacked worker telemetry: the last value per worker
        telemetry = {w: link.hb_telemetry
                     for w, link in self.links.items() if link.hb_telemetry}
        if telemetry:
            counters["worker_telemetry"] = telemetry
        if self.cfg.wire_compression == "sign_ef":
            raw = sum(link.raw_bytes_out for link in self.links.values())
            comp = sum(link.wire_bytes_out for link in self.links.values())
            if comp:
                counters["ef_raw_bytes_out"] = raw
                counters["ef_wire_bytes_out"] = comp
                counters["ef_ratio"] = round(raw / comp, 2)
        # per-link α observations: each worker's clock-probe rtt / 2
        link_alpha = {w: round(st["clock"]["rtt_s"] / 2, 6)
                      for w, st in self.bye_stats.items()
                      if isinstance(st.get("clock"), dict)
                      and "rtt_s" in st["clock"]}
        if link_alpha:
            counters["link_alpha_s"] = link_alpha
        if self.sync_p2p:
            # each unordered link (i, j) once, from the lower endpoint's
            # report (both endpoints count every frame on the link)
            link_bytes: dict[str, int] = {}
            msgs = 0
            for wid, st in sorted(self.bye_stats.items()):
                for peer, c in st.get("peer_links", {}).items():
                    if wid < int(peer):
                        link_bytes[f"{wid}-{peer}"] = c["wire_bytes"]
                        msgs += c["messages"]
            counters["peer_link_bytes"] = link_bytes
            counters["peer_wire_bytes"] = sum(link_bytes.values())
            counters["peer_messages"] = msgs
            rep = self.bye_stats.get(0, {})
            counters["sync_rounds"] = rep.get("sync_rounds", 0)
            # overlap accounting, summed across workers: comm-thread wall
            # seconds vs seconds the update path sat blocked on the wire
            for key in ("comm_s", "exposed_s", "overlapped_s"):
                counters[key] = sum(
                    st.get(key, 0.0) for st in self.bye_stats.values())
            counters["n_buckets"] = rep.get("n_buckets", 1)
            bucket_bytes = [0] * counters["n_buckets"]
            for st in self.bye_stats.values():
                for i, v in enumerate(st.get("bucket_send_bytes", [])):
                    bucket_bytes[i] += int(v)
            counters["bucket_send_bytes"] = bucket_bytes
        trace = self._collect_trace() if self.cfg.trace else None
        sync = self.cfg.algorithm in SYNC
        return PSResult(
            algorithm=self.cfg.algorithm, transport="tcp",
            schedule=((self.sched_name + "+p2p") if self.sync_p2p
                      else self.sched_name if sync else "master"),
            device=str(self.device), history=self.history,
            total_time_s=total_time, total_iters=self.iters,
            counters=counters, final_metric=self.history[-1][2],
            center=self.center.clone(), workers=self.workers_w.clone(),
            trace=trace)

    def _collect_trace(self):
        """Merge the workers' BYE-delivered (or spilled) trace buffers with
        this master's tracers onto the master clock."""
        workers: dict = {}
        for wid, st in self.bye_stats.items():
            payload = st.get("trace")
            if payload is None and st.get("trace_file"):
                try:
                    payload = obs_trace.load_spill(st["trace_file"])
                except OSError:
                    payload = None
            if payload:
                workers[wid] = payload
        master_threads = {t.name: t.spans() for t in obs_trace.drain()
                          if t.n}
        merged = obs_report.merge_traces(
            workers,
            {"threads": master_threads} if master_threads else None)
        merged["report"] = obs_report.breakdown(merged)
        return merged


def run_ps_tcp(problem, easgd, cfg, device=None,
               join_timeout_s: float = 600.0):
    """The tcp transport's ``run_ps``: bind, spawn localhost workers on the
    run's device (unless ``cfg.spawn_workers`` is off: external workers
    join), serve, and return the shared-memory transports' PSResult."""
    master = MasterServer(problem, easgd, cfg, device=device,
                          join_timeout_s=join_timeout_s)
    listener = socket.socket()
    listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    listener.bind((cfg.tcp_host, cfg.tcp_port))
    listener.listen(accept_backlog(cfg.n_workers))
    port = listener.getsockname()[1]
    master._spawned_at = time.monotonic()
    procs = (spawn_local_workers(cfg.tcp_host, port, cfg.n_workers,
                                 master.device)
             if cfg.spawn_workers else [])
    return master.run(listener, procs=procs)

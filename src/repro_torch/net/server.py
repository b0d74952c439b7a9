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
deadlines are taken before a transfer and slept to after it;
``PSConfig.link_slow`` stretches one worker's deadlines (a controlled
straggler on the clock, never on the math). ``PSConfig.topology`` takes
the emulated wire's place: every message is priced over its link class
(intra-host or cross-host; a master link is cross), each p2p worker gets
its own deadlines in WELCOME (``t_wire_s`` / ``t_wire_bucket_s`` over the
messages it touches: an intra-host pair finishes early and waits at the
blocking recv), "auto" is chosen over a link profile (measured here on
the real sockets when none is given), and the run's counters split the
peer bytes into ``intra_host_bytes`` and ``cross_host_bytes``.

The live plane (``PSConfig.telemetry``, ``obs.live``): every
telemetry-bearing HEARTBEAT feeds a ``LiveMonitor`` through
``Link.hb_hook``, a sampler thread adds per-link heartbeat age and the
aggregate gauges (wid −1) and runs the health detector, and a control
acceptor answers STATS requests on the rendezvous listener until shutdown.

Elastic membership (``PSConfig.elastic``, ``ft.membership``): a worker's
death or clean preemption becomes a ``member_lost`` event instead of a
RuntimeError. The master plane drops the worker from its roster (the sync
pair rebuilds its rounds, padding and device mailbox for the new P); the
p2p plane runs a two-phase RECONFIGURE (``_reconfigure_p2p``) onto the
survivors, and a respawned worker's HELLO on the listener rejoins it at
the next epoch (``_admit_rejoin``). Every transition is a health event.

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
from repro_torch.core import costmodel, easgd_flat
from repro_torch.core.compression import sign_ef_wire_nbytes
from repro_torch.ft import chaos as ft_chaos
from repro_torch.ft import membership as ft_membership
from repro_torch.kernels.elastic_update import (fused_sync_easgd_update,
                                                fused_sync_sgd_update)
from repro_torch.net import wire
from repro_torch.net.wire import HostRow, Link, sleep_until
from repro_torch.obs import live as obs_live
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
                     peer_port: int | None = None, device=None) -> str:
    """The ``REPRO_CLUSTER_SPEC`` JSON that names one worker's run: the
    worker CLI fills any connection detail its command line leaves out
    from it, so a respawn is ``python -m repro_torch.net.worker --rejoin``
    with this variable set."""
    spec = {"role": role, "wid": wid, "host": host, "port": int(port),
            "token": token}
    if device is not None:
        spec["device"] = str(device)
    if sync_plane is not None:
        spec["sync_plane"] = sync_plane
    if peer_port is not None:
        spec["peer_port"] = int(peer_port)
    return json.dumps(spec)


def spawn_local_workers(host: str, port: int, n_workers: int, device,
                        token: str = DEFAULT_TOKEN,
                        env_extra: dict | None = None) -> list:
    """Start ``n_workers`` localhost worker interpreters on ``device``.
    Unless the environment says otherwise, each gets an equal share of the
    host's cores for its CPU thread pools (``OMP_NUM_THREADS``, as
    ``torchrun`` does): P interpreters each spinning a pool the size of the
    host oversubscribe it many times over. Each child also gets the
    ``REPRO_CLUSTER_SPEC`` of its own role, so a respawn is a re-exec;
    ``env_extra`` carries run-scoped injections (``REPRO_CHAOS``)."""
    base = worker_env()
    base.setdefault("OMP_NUM_THREADS",
                    str(max(1, (os.cpu_count() or 1) // (n_workers + 1))))
    if env_extra:
        base.update(env_extra)
    procs = []
    for i in range(n_workers):
        env = dict(base)
        env["REPRO_CLUSTER_SPEC"] = cluster_spec_env("worker", i, host, port,
                                                     token, device=device)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.net.worker",
             "--connect", f"{host}:{port}", "--wid", str(i),
             "--token", token, "--device", str(device)],
            env=env))
    return procs


_STANDBY = ("import os, sys\n"
            "from repro_torch.net import worker\n"
            "spec = sys.stdin.readline()\n"
            "if spec.strip():\n"
            "    os.environ['REPRO_CLUSTER_SPEC'] = spec\n"
            "    worker.main(['--rejoin'])\n")


class Respawner:
    """Respawn worker ``wid`` of a running elastic tcp master — ``python -m
    repro_torch.net.worker --rejoin`` with its ``REPRO_CLUSTER_SPEC`` — when
    an event of ``kind`` reaches the run's telemetry JSONL stream. The
    stream's header names the master's listener (``meta["addr"]``), so the
    master may bind port 0.

    ``standby=True`` starts the interpreter at once and hands it the spec
    on stdin when the event lands: a hot spare whose imports are done
    before the fault, so its rejoin does not wait for ``import torch``.
    Use it as a context manager around the run; ``spawned`` holds
    (monotonic time the worker was released, Popen), and ``finish``
    collects the respawn's exit code and output."""

    def __init__(self, jsonl, wid: int, device, kind: str = "reconfigure",
                 timeout_s: float = 600.0, standby: bool = False,
                 n_workers: int = 4):
        self.jsonl, self.wid, self.device = str(jsonl), wid, device
        self.kind, self.timeout_s = kind, timeout_s
        self.spawned: list = []
        self._stop = threading.Event()
        self._env = worker_env()
        self._env.setdefault("OMP_NUM_THREADS",
                             str(max(1, (os.cpu_count() or 1)
                                     // (n_workers + 1))))
        self._spare = (subprocess.Popen(
            [sys.executable, "-c", _STANDBY], env=self._env,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) if standby else None)
        self._thread = threading.Thread(target=self._watch, daemon=True)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=10)
        if self._spare is not None and not self.spawned:
            self._spare.kill()           # never released: no rejoin wanted
            self._spare.communicate()
        return False

    def _scan(self):
        """(master address or None, whether the event has landed)."""
        try:
            with open(self.jsonl) as f:
                lines = f.read().splitlines()
        except OSError:
            return None, False
        addr, seen = None, False
        for line in lines:
            try:
                rec = json.loads(line)
            except ValueError:
                continue                 # a line still being written
            if "meta" in rec:
                addr = rec["meta"].get("addr")
            seen |= any(e.get("kind") == self.kind
                        for e in rec.get("events", ()))
        return addr, seen

    def _watch(self) -> None:
        deadline = time.monotonic() + self.timeout_s
        while not self._stop.is_set() and time.monotonic() < deadline:
            addr, seen = self._scan()
            if seen and addr:
                host, port = addr.rsplit(":", 1)
                spec = cluster_spec_env("worker", self.wid, host, int(port),
                                        device=self.device)
                if self._spare is not None:
                    self._spare.stdin.write(spec + "\n")
                    self._spare.stdin.close()
                    self._spare.stdin = None     # communicate() skips it
                    proc = self._spare
                else:
                    env = dict(self._env, REPRO_CLUSTER_SPEC=spec)
                    proc = subprocess.Popen(
                        [sys.executable, "-m", "repro_torch.net.worker",
                         "--rejoin"], env=env, stdout=subprocess.PIPE,
                        stderr=subprocess.STDOUT, text=True)
                self.spawned.append((time.monotonic(), proc))
                return
            time.sleep(0.02)

    def finish(self, timeout_s: float = 60.0) -> tuple:
        """(exit code, output) of the respawn; (None, "") if the event
        never came. A respawn still running after ``timeout_s`` is
        killed."""
        if not self.spawned:
            return None, ""
        proc = self.spawned[0][1]
        try:
            out, _ = proc.communicate(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
        return proc.returncode, out


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
        # heterogeneous fabric: the topology prices every pacing sleep per
        # link class; with schedule="auto" and no profile given, one is
        # measured now (a short burst over the real sockets) so the choice
        # ranks the schedules on the fabric the run has
        self.topology = cfg.topology
        self.profile = cfg.link_profile
        if (self.topology is not None and self.profile is None
                and cfg.schedule == "auto"):
            from repro_torch.ps.runtime import measured_link_profile
            self.profile = measured_link_profile(cfg)
        self.sched_name = cfg.resolved_schedule(n * 8, profile=self.profile)
        self.rounds = (comm_schedules.get(self.sched_name)
                       .rounds(P, n * 8, cfg.net, topology=self.topology)
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
        # layer sizes outlive the build: an elastic reconfiguration
        # re-derives the bucket boundaries for the new padded size
        self._layer_sizes = getattr(grad_fn, "layer_sizes", None)
        self.boundaries = None
        if cfg.bucket_bytes > 0 and cfg.algorithm in SYNC:
            self.boundaries = comm_rounds.default_bucket_boundaries(
                self._layer_sizes, padded, cfg.bucket_bytes)

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
        # events of READY workers that came before every worker was READY,
        # handed on, in order, ahead of the queue once the run serves
        self._early: list = []
        # host staging, one buffer per wid and direction: n elements each
        # (never the padded row), so a reconfiguration that changes P and
        # the padding leaves them valid — a rejoiner reuses its wid's
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
        self._draining = False           # True once DONE went out: BYE is
        #                                  then the expected shutdown frame,
        #                                  not a mid-run departure
        self.live = None                 # obs.live.LiveMonitor (telemetry)
        # -- elastic membership (ft.membership) ----------------------------
        self.elastic = bool(cfg.elastic)
        self.membership = (ft_membership.MembershipTable(P)
                           if self.elastic else None)
        self._serving = False            # losses are absorbed only once the
        #                                  disciplines run — a rendezvous
        #                                  death still raises
        self._elastic_events: list = []  # lifecycle record (telemetry off
        #                                  too: PSResult.health names them)
        self._marks: list = []           # [kind, wid, time.monotonic()] of
        #                                  every lifecycle event: the
        #                                  recovery and rejoin clocks
        self._proc_reported: set = set()
        self._epoch_round_base = 0       # p2p iteration accounting across
        self._epoch_iters_base = 0       # epochs: iters(k) = base_iters +
        self._epoch_p = P                # (k − base_round) · P_epoch · τ
        self._epoch_members: set = set()
        self._pending_rejoin: list = []
        self._rosters: dict = {}         # master-plane sync rounds served:
        #                                  (P, update launches) → rounds
        self._addr = ""                  # the listener, "host:port"

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

    def _t_msg_pair(self, wid: int | None = None) -> tuple:
        """(t_down, t_up) emulated per-message times of the post-codec
        payloads. ``wid`` applies that worker's ``PSConfig.link_slow``
        stretch: a controlled straggler on the pacing plane only
        (admission order and math are untouched — the detector must find
        it, not the iterates)."""
        codec = self.cfg.wire_compression
        slow = self.cfg.link_slow_factor(wid) if wid is not None else 1.0
        if self.topology is not None:
            # a master link rides the (MASTER, wid) class: cross-host
            # whenever hosts > 1 — the master is its own host
            link = self.topology.link(comm_rounds.MASTER,
                                      0 if wid is None else wid)
            return (slow * costmodel.t_msg(
                        wire_payload_nbytes(self._down_elems(), codec), link),
                    slow * costmodel.t_msg(
                        wire_payload_nbytes(self._up_elems(), codec), link))
        return (slow * self.cfg.t_msg_emulated(
                    wire_payload_nbytes(self._down_elems(), codec)),
                slow * self.cfg.t_msg_emulated(
                    wire_payload_nbytes(self._up_elems(), codec)))

    def _n_sync_rounds(self) -> int:
        return -(-self.cfg.total_iters // (self.cfg.n_workers * self.tau))

    def _t_sync_wire(self, wid: int | None = None) -> float:
        """Emulated time of one exchange: the rounds serialize, each
        costs α + max_frac·n·β. Under a topology each message is priced
        over its link class, and ``wid`` keeps that worker's own segments:
        its deadline on a heterogeneous mesh (an intra-host pair finishes
        early and waits on its cross-host peers at the blocking recv)."""
        if self.topology is not None:
            return comm_rounds.t_rounds(self.rounds, self.n * 8,
                                        topology=self.topology, wid=wid)
        return sum(
            self.cfg.t_msg_emulated(max(m.frac for m in rnd) * self.n * 8)
            for rnd in self.rounds)

    def _t_sync_wire_buckets(self, wid: int | None = None) -> list:
        """Per-bucket emulated wire time of the bucketed view (topology
        and ``wid`` as in ``_t_sync_wire``)."""
        if self.topology is not None:
            return comm_rounds.t_rounds_buckets(
                self.rounds, self.padded, self.boundaries,
                topology=self.topology, wid=wid)
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

    def _welcome_payload(self, wid: int, rejoin: bool = False) -> dict:
        """One worker's WELCOME: the problem spec and algorithm, plus the
        p2p geometry on that plane. A rejoin WELCOME names the current
        epoch's geometry, but the worker joins the mesh only at the
        RECONFIGURE that folds it in."""
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
            "hb_interval_s": cfg.hb_interval_eff_s(),
            "trace": bool(cfg.trace),
            "trace_dir": cfg.trace_dir,
        }
        if self.topology is not None:
            welcome["topology"] = self.topology.to_wire()
        if self.profile is not None:
            welcome["link_profile"] = self.profile.to_wire()
        if self.sync_p2p:
            # a link_slow worker paces its exchange deadlines slower: the
            # mesh is lockstep, so its lag shows in every worker's clock,
            # but its own heartbeat telemetry is what names it
            slow = cfg.link_slow_factor(wid)
            own = wid if self.topology is not None else None
            welcome.update({
                "sync_plane": "p2p",
                "p": len(self.links) if rejoin else cfg.n_workers,
                "padded": self.padded,
                "rounds": comm_rounds.rounds_to_wire(self.rounds),
                "n_rounds": self._n_sync_rounds(),
                "eval_rounds": self._eval_rounds(),
                "t_wire_s": slow * self._t_sync_wire(own),
                "peers": {str(w): a for w, a in self.peer_addrs.items()},
                "bucket_bounds": self.boundaries,
                "overlap": cfg.overlap,
                "t_wire_bucket_s": ([slow * t for t in
                                     self._t_sync_wire_buckets(own)]
                                    if self.boundaries else []),
                "elastic": self.elastic,
            })
        if rejoin:
            welcome["rejoin"] = True
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
            if kind != "ready" and wid in ready:
                # a READY worker already at work (the p2p plane needs no
                # word from the master): its event waits for the serve loop
                self._early.append((wid, kind, detail))
                continue
            if kind != "ready":
                raise RuntimeError(
                    f"worker {wid} failed during rendezvous: {kind} {detail}")
            ready.add(wid)
            self.ready_s[wid] = round(time.monotonic() - self._spawned_at, 3)
            if self.membership is not None:
                self.membership.mark_ready(wid)

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
                    # round ≥ 0, −1 final, −2 a reconfiguration's state
                    # upload); a fresh array keeps a slow eval from racing
                    # the next report
                    self.events.put((wid, "center",
                                     (frame.wid,
                                      link.recv_array(frame).copy())))
                elif frame.ftype == wire.RECONFIGURE:
                    # a member acking phase 1 with its completed rounds
                    self.events.put((wid, "reconf_ack",
                                     link.recv_json(frame)))
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
        for i, proc in enumerate(self._procs):
            rc = proc.poll()
            if rc in (None, 0):
                continue
            if self.elastic and self._serving:
                # under elastic membership a nonzero exit is a membership
                # signal: surfaced once as a dead event (the reader's
                # socket-drop event usually comes first)
                if (not self.membership.is_lost(i)
                        and i not in self._proc_reported):
                    self._proc_reported.add(i)
                    self.events.put((i, "dead", f"process exited {rc}"))
                continue
            raise RuntimeError(
                f"tcp worker {i} process exited with code {rc} "
                f"(algorithm={self.cfg.algorithm})")

    def _mark_event(self, wid: int, kind: str, detail: str = "") -> None:
        """One lifecycle record: through the LiveMonitor when telemetry is
        on (events, JSONL, health counters), into the local log always —
        PSResult.health names every death and recovery on a bare run
        too."""
        if self.live is not None:
            ev = self.live.mark_worker_event(wid, kind, detail)
        else:
            ev = {"t": round(time.perf_counter()
                             - (self._t0 or time.perf_counter()), 3),
                  "kind": kind, "wid": wid,
                  **({"detail": detail} if detail else {})}
        self._elastic_events.append(ev)
        self._marks.append([kind, wid, time.monotonic()])

    def _member_lost(self, wid: int, kind: str, detail):
        """Elastic conversion of a failure into a membership transition:
        close the link, record the change, hand the serve loop a
        ``member_lost`` event instead of raising."""
        left = kind == "bye"                       # clean preemption BYE
        if left:
            self.membership.mark_left(wid, "clean BYE mid-run")
        else:
            self.membership.mark_dead(wid, str(detail))
        link = self.links.pop(wid, None)
        if link is not None:
            link.hb_hook = None
            link.close()
        self._mark_event(wid, "worker_left" if left else "worker_dead",
                         str(detail or ""))
        return wid, "member_lost", str(detail or "")

    def _next_event(self, timeout: float):
        """Pop one event; worker failures and heartbeat silence raise
        instead of hanging the launcher — unless elastic membership is on
        and the disciplines run, when a loss becomes a ``member_lost``
        event the serve loop absorbs."""
        if self._early and self._serving:
            return self._early.pop(0)
        deadline = time.monotonic() + max(timeout, 0.0)
        absorb = self.elastic and self._serving
        while True:
            self._check_procs()
            if self.links:
                worst = max(time.monotonic() - l.last_seen
                            for l in list(self.links.values()))
                cell = self.counters.gauge("hb_staleness_max_s")
                cell.value = max(cell.value, round(worst, 3))
            hb_timeout = self.cfg.hb_timeout_eff_s()
            stale = [w for w, l in list(self.links.items())
                     if time.monotonic() - l.last_seen > hb_timeout]
            if stale:
                if absorb:
                    return self._member_lost(
                        stale[0], "dead",
                        f"silent for more than {hb_timeout}s")
                raise RuntimeError(
                    f"worker(s) {stale} silent for more than "
                    f"{hb_timeout}s (heartbeats stopped)")
            try:
                wid, kind, detail = self.events.get(timeout=0.5)
            except queue.Empty:
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"timed out waiting for workers "
                        f"(algorithm={self.cfg.algorithm})") from None
                continue
            if kind in ("error", "dead"):
                if absorb and wid in self.links:
                    return self._member_lost(wid, kind, detail)
                if absorb:
                    continue             # a second signal of a known loss
                if self.live is not None:
                    self.live.mark_worker_event(wid, "worker_dead",
                                                str(detail))
                raise RuntimeError(f"worker {wid} failed: {detail}")
            if kind == "bye" and not self._draining:
                # a clean mid-run departure (SIGTERM → BYE, not a dead
                # socket): its flush already landed in bye_stats
                if absorb:
                    return self._member_lost(wid, "bye", "preempted")
                if self.live is not None:
                    self.live.mark_worker_event(wid, "worker_left",
                                                "clean BYE mid-run")
                raise RuntimeError(
                    f"worker {wid} left the run (clean BYE mid-run — "
                    f"preempted?)")
            return wid, kind, detail

    def _await(self, kind: str, need: set, ignore: tuple = ()) -> None:
        """Block until every wid in ``need`` delivered one ``kind`` event;
        ``ignore`` skips exchanges still in flight when DONE went out."""
        pending = set(need)
        while pending:
            wid, got, _ = self._next_event(self.timeout)
            if got in ignore:
                continue
            if got == "member_lost":     # elastic: the lost worker owes
                pending.discard(wid)     # nothing any more
                continue
            if got != kind:
                raise RuntimeError(
                    f"protocol violation: expected {kind} from {pending}, "
                    f"got {got} from worker {wid}")
            pending.discard(wid)

    # -- live telemetry plane (obs.live) -------------------------------------

    def _start_live(self) -> None:
        """Telemetry on: build the LiveMonitor, point every link's
        heartbeat hook at its store and start the sampler thread.
        Telemetry off (the default) never reaches here: no store, no
        threads, no timestamps."""
        cfg = self.cfg
        self.counters.counter("health_events")
        self.live = obs_live.LiveMonitor(
            cfg.n_workers, deadline_factor=cfg.straggler_factor,
            hb_interval_s=cfg.hb_interval_eff_s(),
            jsonl_path=cfg.telemetry_jsonl,
            counters=self.counters,
            meta={"algorithm": cfg.algorithm, "transport": "tcp",
                  "device": str(self.device), "addr": self._addr,
                  "schedule": self.sched_name
                  + ("+p2p" if self.sync_p2p else "")})
        for wid, link in self.links.items():
            link.hb_hook = (lambda payload, w=wid:
                            self.live.ingest_hb(w, payload))
        th = threading.Thread(target=self._live_sampler, daemon=True)
        th.start()
        self._threads.append(th)

    def _live_sampler(self) -> None:
        """Periodic master-side pass: per-link heartbeat age and ef_ratio
        into the store, the aggregate gauges under wid −1, one detector
        pass. Links are read from a snapshot of the dict each pass —
        membership changes it concurrently. Every value is a plain
        number: no tensor is read here."""
        period = self.cfg.telemetry_period_s()
        while not self._closing.wait(period):
            now = time.monotonic()
            links = list(self.links.items())
            staleness = {w: round(now - link.last_seen, 3)
                         for w, link in links}
            for w, link in links:
                ratio = link.ef_ratio()
                if ratio is not None:
                    self.live.ingest_hb(w, {"ef_ratio": round(ratio, 2)})
            gauges = {k: v for k, v in self.counters.snapshot().items()
                      if isinstance(v, (int, float))}
            gauges["iters"] = self.iters
            self.live.sample(staleness=staleness, gauges=gauges)

    def _start_acceptor(self, listener: socket.socket, token: str) -> None:
        th = threading.Thread(target=self._control_acceptor,
                              args=(listener, token), daemon=True)
        th.start()
        self._threads.append(th)

    def _control_acceptor(self, listener: socket.socket, token: str) -> None:
        """Connections on the rendezvous listener after rendezvous: STATS
        requests from monitors (one request a connection) and, under
        elastic membership, HELLOs of respawned workers (handed to the
        serve loop as a ``rejoin_hello`` event: admission happens there,
        on the thread that owns the run state). It owns the listener from
        rendezvous to shutdown; ``run`` closes the listener, which ends
        this loop without a join."""
        while not self._closing.is_set():
            try:
                conn, _ = listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return                   # listener closed at shutdown
            client = None
            keep = False
            try:
                conn.settimeout(10.0)
                client = Link(conn, codec=self.cfg.wire_compression,
                              counters=self.link_counters)
                frame = client.recv_header()
                if frame.ftype == wire.STATS and self.live is not None:
                    req = client.recv_json(frame)
                    if req.get("token") != token:
                        client.send_json(wire.ERROR, {"msg": "bad token"})
                        continue
                    client.send_json(
                        wire.STATS,
                        self.live.snapshot(int(req.get("k", 32))))
                    continue
                if frame.ftype == wire.HELLO and self.elastic:
                    hello = client.recv_json(frame)
                    wid = int(hello.get("wid", -1))
                    if hello.get("token") != token:
                        client.send_json(wire.ERROR, {"msg": "bad token"})
                        continue
                    if not (0 <= wid < self.cfg.n_workers):
                        client.send_json(wire.ERROR,
                                         {"msg": f"bad wid {wid}"})
                        continue
                    if wid in self.links or not self.membership.is_lost(wid):
                        client.send_json(wire.ERROR, {
                            "msg": f"wid {wid} is not rejoinable "
                                   f"(state {self.membership.state(wid)})"})
                        continue
                    if not self.sync_p2p:
                        client.send_json(wire.ERROR, {
                            "msg": "rejoin is a p2p sync-plane feature"})
                        continue
                    conn.settimeout(self.timeout)
                    keep = True
                    self.events.put((wid, "rejoin_hello",
                                     {"link": client,
                                      "peer": hello.get("peer")}))
            except (socket.timeout, wire.WireError, OSError, ValueError):
                pass
            finally:
                if not keep:
                    if client is not None:
                        client.close()
                    else:
                        conn.close()

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
        link = self.links.get(wid)
        if link is None:                 # elastic: lost since it was chosen
            return 0
        down = self.down_host[wid]
        try:
            if self._down_stacked:
                return link.send_array(
                    wire.WEIGHTS, down.put(self.workers_w[wid],
                                           self.workers_v[wid]),
                    wid=wid, segments=2)
            return link.send_array(
                wire.WEIGHTS, down.put(self.workers_w[wid]), wid=wid)
        except (wire.WireError, OSError):
            if self.elastic and self._serving:
                return 0                 # its reader surfaces the loss
            raise

    def serve(self) -> None:
        algo = self.cfg.algorithm
        self._t0 = time.perf_counter()
        self._serving = True             # elastic: losses are now absorbed
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
        the turn arrives, so the wire serializes the whole pipeline.
        Elastic: the rotation runs over the live roster each turn — a lost
        worker drops out of the cycle and its turn is served again."""
        e, cfg = self.easgd, self.cfg
        n_turns = -(-cfg.total_iters // self.tau)
        turn = served = 0
        while served < n_turns:
            roster = sorted(self.links)
            if not roster:
                raise RuntimeError("elastic: every worker was lost")
            j = roster[turn % len(roster)]
            turn += 1
            t_down, t_up = self._t_msg_pair(j)
            deadline = time.monotonic() + t_down
            self._send_weights(j)
            if t_down:
                sleep_until(deadline)            # W̄ down
            self._await("grad", {j})
            if j not in self.links:              # lost while awaited
                continue
            grad = self._absorb_upload(j)
            deadline = time.monotonic() + t_up
            easgd_flat.master_absorb_round_robin(
                self.center, self.workers_w[j], self.workers_v[j], grad, e)
            if t_up:
                sleep_until(deadline)            # W⁽ʲ⁾ up
            served += 1
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
        turn = 0
        while self.iters < cfg.total_iters:
            j = turn % cfg.n_workers
            t_pair = sum(self._t_msg_pair(j))
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
        serializes both messages of each exchange. Elastic: a lost
        worker's quota is absorbed by the others' arrivals."""
        e, cfg = self.easgd, self.cfg
        wire_free_at = 0.0
        for wid in self.links:
            self._send_weights(wid)
        while self.iters < cfg.total_iters:
            j, kind, _ = self._next_event(self.timeout)
            if kind == "member_lost":
                if not self.links:
                    raise RuntimeError("elastic: every worker was lost")
                continue
            if kind != "grad":
                raise RuntimeError(f"expected a grad, got {kind}")
            t_pair = sum(self._t_msg_pair(j))
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
        t_pairs = [sum(self._t_msg_pair(w)) for w in range(P)]
        quota = [(total // P + (1 if w < total % P else 0)) for w in range(P)]
        target = [-(-q // self.tau) for q in quota]   # exchanges per worker
        done = [0] * P
        replies: queue.Queue = queue.Queue()          # (deadline, wid)
        stop = threading.Event()

        def _delayed_sender():
            # a deadline heap, not FIFO: with per-link pacing (link_slow) a
            # slow worker's long reservation must not hold back the fast
            # workers' short ones
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
        lost_any = False
        try:
            for wid in self.links:
                self._send_weights(wid)
            while any(d < t for d, t in zip(done, target)):
                j, kind, _ = self._next_event(self.timeout)
                if kind == "member_lost":
                    # elastic: forgive the lost worker's remaining quota —
                    # hogwild has no barrier to rebalance; the run ends
                    # those iterations short
                    target[j] = done[j]
                    lost_any = True
                    if not self.links:
                        raise RuntimeError("elastic: every worker was lost")
                    continue
                if kind != "grad":
                    raise RuntimeError(f"expected a grad, got {kind}")
                grad = self._absorb_upload(j)
                deadline = time.monotonic() + t_pairs[j]
                easgd_flat.master_absorb(
                    cfg.algorithm, self.center, self.master_vel,
                    self.workers_w[j], self.workers_v[j], grad, e)
                done[j] += 1
                self.iters += self.tau
                self._maybe_eval()
                if done[j] < target[j]:
                    if t_pairs[j]:
                        replies.put((deadline, j))
                    else:
                        self._send_weights(j)
        finally:
            stop.set()
            sender.join(timeout=5)
        if not lost_any:
            self.iters = total                        # quota-exact

    def _rebuild_sync_plan(self, p: int) -> None:
        """Elastic membership shrank the master plane's sync family to
        ``p`` workers: re-resolve dense rounds, padding, bucket boundaries
        and the device mailbox, ``(p + 1, padded)``, for P′ — the
        participation mask realized as geometry. The workers are
        request-reply clients here, so nothing ships to them."""
        self.rounds = comm_schedules.get(self.sched_name).rounds(
            p, self.n * 8, self.cfg.net)
        self.padded = self.n + (-self.n) % max(p, 1)
        if self.cfg.bucket_bytes > 0:
            self.boundaries = comm_rounds.default_bucket_boundaries(
                self._layer_sizes, self.padded, self.cfg.bucket_bytes)
        self.mailbox = torch.zeros((p + 1, self.padded), dtype=torch.float64,
                                   device=self.device)
        epoch = self.membership.advance_epoch()
        self.counters.gauge("epoch").value = epoch
        if self.live is not None:
            self.live.set_membership(sorted(self.links))
        self._mark_event(-1, "reconfigure",
                         f"epoch {epoch}: p={p} "
                         f"survivors={sorted(self.links)} (centralized)")

    def _serve_sync(self) -> None:
        """Barriered rounds over links. Sync EASGD's all-reduce runs on the
        master's mailbox while the workers compute their gradients (the
        §6.1.3 overlap); Sync SGD's must wait for the gradients.

        Elastic: each round runs over the live roster — on a loss the
        surviving rows are packed densely, the plan rebuilt for P′ and the
        mean taken over P′. A worker lost after its state entered the
        mailbox still counts in that one exchange (its own update is
        skipped); it is out of the roster from the next round on."""
        e, cfg = self.easgd, self.cfg
        algo, n = cfg.algorithm, self.n
        plan_p = cfg.n_workers
        # the centralized exchange is one barriered pipeline: a slow link
        # slows the whole round, so link_slow stretches the shared pacing
        # by the worst factor
        t_factor = max(cfg.link_slow) if cfg.link_slow else 1.0
        t_wire = self._t_sync_wire() * t_factor
        tr = self.tracer
        while self.iters < cfg.total_iters:
            roster = sorted(self.links)
            if not roster:
                raise RuntimeError("elastic: every worker was lost")
            for wid in roster:
                self._send_weights(wid)
            if algo == "sync_easgd":
                got_grad: set = set()
                if self.tau > 1:
                    # workers post their evolved weights (WSTATE) before
                    # the exchange gradient; a fast worker's GRAD may
                    # arrive before a slow one's WSTATE
                    got_w: set = set()
                    need = set(roster)
                    while not need <= got_w:
                        wid, kind, _ = self._next_event(self.timeout)
                        if kind == "member_lost":
                            need.discard(wid)
                            got_grad.discard(wid)
                        elif kind == "wstate":
                            self.wstate_host[wid].get(self.workers_w[wid])
                            got_w.add(wid)
                        elif kind == "grad":
                            got_grad.add(wid)
                        else:
                            raise RuntimeError(
                                f"expected a wstate or grad, got {kind}")
                roster = [w for w in roster if w in self.links]
                P = len(roster)
                if P == 0:
                    continue             # everyone was lost this round
                if P != plan_p:
                    self._rebuild_sync_plan(P)
                    plan_p = P
                    t_wire = self._t_sync_wire() * t_factor
                if P == self.workers_w.shape[0]:
                    self.mailbox[:P, :n].copy_(self.workers_w)
                else:
                    self.mailbox[:P, :n].copy_(self.workers_w[roster])
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
                # a late loss skips its own update; the first update still
                # standing also writes the new center (the flip buffer)
                live = [i for i in roster if i in self.links]
                for k, i in enumerate(live):
                    fused_sync_easgd_update(
                        self.workers_w[i], self._absorb_upload(i),
                        self.center, row, P, e.eta, e.rho,
                        center_out=self.center_alt if k == 0 else None)
                if live:
                    self.center, self.center_alt = (self.center_alt,
                                                    self.center)
                self._served(P, len(live))
                if tr is not None:
                    tr.record(obs_trace.UPDATE, t0, tr.now())
            else:                                     # sync_sgd
                if tr is not None:
                    t0 = tr.now()
                self._await("grad", set(roster))
                if tr is not None:
                    tr.record(obs_trace.RECV_WAIT, t0, (t0 := tr.now()))
                roster = [w for w in roster if w in self.links]
                P = len(roster)
                if P == 0:
                    continue
                if P != plan_p:
                    self._rebuild_sync_plan(P)
                    plan_p = P
                    t_wire = self._t_sync_wire() * t_factor
                for r, i in enumerate(roster):
                    self.up_host[i].get(self.mailbox[r, :n])
                deadline = time.monotonic() + t_wire
                execute_rounds(self.mailbox, n, self.rounds, self.counters,
                               boundaries=self.boundaries, tracer=tr)
                if t_wire:
                    sleep_until(deadline)
                if tr is not None:
                    tr.record(obs_trace.EXCHANGE, t0, (t0 := tr.now()))
                fused_sync_sgd_update(self.center, self.master_vel,
                                      self.mailbox[0, :n], P, e.eta, e.mu)
                self._served(P, 1)
                self.workers_w.copy_(self.center.expand_as(self.workers_w))
                if tr is not None:
                    tr.record(obs_trace.UPDATE, t0, tr.now())
            self.iters += P * self.tau
            self._maybe_eval()

    def _served(self, p: int, updates: int) -> None:
        """Log one master-plane sync round: its roster size and the update
        launches it made (``counters["sync_rosters"]`` under elastic)."""
        self._rosters[(p, updates)] = self._rosters.get((p, updates), 0) + 1

    def _p2p_iters_at(self, k: int) -> int:
        """Total iterations once exchange round ``k`` completes, summed
        across epochs: rounds before the epoch's base ran at earlier P's."""
        return (self._epoch_iters_base
                + (k + 1 - self._epoch_round_base) * self._epoch_p
                * self.tau)

    def _p2p_center_report(self, tag: int, payload) -> bool:
        """Take one tagged CENTER report: tag ≥ 0 is an eval report after
        exchange round ``tag``, −1 the final center. Returns True for the
        final report."""
        n = self.n
        self.center.copy_(torch.from_numpy(payload[:n]))
        if payload.size >= 2 * n:        # sync_sgd state: [center|vel]
            self.master_vel.copy_(torch.from_numpy(payload[n:2 * n]))
        if tag >= 0:
            self.iters = self._p2p_iters_at(tag)
            self._maybe_eval(force=True)
            return False
        self.iters = self._p2p_iters_at(self._n_sync_rounds() - 1)
        return True

    def _serve_sync_p2p(self) -> None:
        """The p2p control plane: the workers run the rounds among
        themselves, so this loop only takes the reporter's CENTER reports
        (tagged with the exchange round: reports and reconfigurations can
        interleave), each worker's final WSTATE, and the heartbeat / error
        machinery of ``_next_event``.

        Under ``PSConfig.elastic`` it also drives membership: a
        ``member_lost`` event runs ``_reconfigure_p2p``; a respawned
        worker's HELLO (handed over by the control acceptor) is admitted
        here and folded in by another reconfiguration once its READY
        lands."""
        self._epoch_members = set(self.links)
        self._epoch_p = len(self.links)
        final_center = False
        wstates: set = set()
        self._pending_rejoin = []
        while not (final_center and wstates >= set(self.links)):
            wid, kind, detail = self._next_event(self.timeout)
            if kind == "center":
                final_center |= self._p2p_center_report(*detail)
            elif kind == "wstate":
                self.wstate_host[wid].get(self.workers_w[wid])
                wstates.add(wid)
            elif kind == "member_lost":
                if final_center:
                    continue             # already past the last exchange
                self._reconfigure_p2p()
            elif kind == "rejoin_hello":
                if final_center:
                    detail["link"].close()
                else:
                    self._admit_rejoin(wid, detail["link"], detail["peer"])
            elif kind == "ready":
                # a respawned worker finished building: fold it in at the
                # next epoch (the reconfiguration ships rounds and state)
                self.membership.mark_rejoined(wid)
                self._mark_event(wid, "worker_rejoined",
                                 f"enters at epoch {self.membership.epoch + 1}")
                self._reconfigure_p2p()
            elif kind == "reconf_ack":
                # a restarted reconfiguration makes workers ack one epoch
                # twice; the leftovers are harmless latecomers
                continue
            else:
                raise RuntimeError(
                    f"protocol violation on the p2p control plane: "
                    f"got {kind} from worker {wid} ({detail!r})")

    def _admit_rejoin(self, wid: int, link: Link, peer) -> None:
        """Wire a respawned worker back in: register its link and reader
        and send a rejoin WELCOME. It builds its problem while the run goes
        on; its READY triggers the reconfiguration that folds it in."""
        if not peer:
            link.send_json(wire.ERROR,
                           {"msg": "p2p rejoin needs a peer listener"})
            link.close()
            return
        self.peer_addrs[wid] = list(peer)
        self.links[wid] = link
        if self.live is not None:
            link.hb_hook = (lambda payload, w=wid:
                            self.live.ingest_hb(w, payload))
        # the original process of this wid is a corpse that stays in
        # self._procs: mark it reported for good, so its exit code is never
        # taken for a death of the respawn (whose loss shows on its socket)
        self._proc_reported.add(wid)
        self._mark_event(wid, "worker_rejoining")
        link.send_json(wire.WELCOME, self._welcome_payload(wid, rejoin=True))
        th = threading.Thread(target=self._reader, args=(wid, link),
                              daemon=True)
        th.start()
        self._threads.append(th)

    def _reconfigure_p2p(self) -> None:
        """Freeze → re-resolve → rewire → resume (the master half of the
        membership protocol).

        Phase 1 ships the next epoch's geometry — roster, the rounds
        re-resolved for P′ and remapped onto the member wids, new padding
        and bucket boundaries, the peer directory — to every member.
        Members stop at an exchange boundary (or fall out of the doomed
        exchange), tear their mesh links down, and ack with the number of
        exchange rounds they have completed. Phase 2 broadcasts the agreed
        resume round — the minimum over the previous epoch's members; every
        worker ahead of it rolls back to its start-of-round snapshot, so
        the new epoch's first exchange runs over bitwise-agreeing replicas
        — and the new eval cadence. With a joiner present, the lowest
        previous member uploads its rolled-back state and the master
        relays it, so the joiner enters with the exact center (and
        velocity) bits. Another loss mid-reconfiguration restarts the
        procedure with the smaller roster."""
        cfg = self.cfg
        while True:
            prev = sorted(w for w in self._epoch_members if w in self.links)
            roster = sorted(self.links)
            if not prev:
                raise RuntimeError(
                    "elastic: no previous-epoch survivor holds the state — "
                    "the run cannot continue")
            p = len(roster)
            epoch = self.membership.epoch + 1
            padded = self.n + (-self.n) % p
            rounds = comm_schedules.get(self.sched_name).rounds(
                p, self.n * 8, cfg.net)
            self.rounds = comm_rounds.remap_rounds(
                rounds, ft_membership.dense_rank_map(roster))
            self.padded = padded
            if cfg.bucket_bytes > 0:
                self.boundaries = comm_rounds.default_bucket_boundaries(
                    self._layer_sizes, padded, cfg.bucket_bytes)
            joiners = [w for w in roster if w not in prev]
            phase1 = {
                "phase": 1, "epoch": epoch, "p": p,
                "survivors": roster,
                "rounds": comm_rounds.rounds_to_wire(self.rounds),
                "padded": padded,
                "peers": {str(w): self.peer_addrs[w] for w in roster},
                "bucket_bounds": self.boundaries,
                "n_rounds": self._n_sync_rounds(),
                "sync_wid": prev[0],
                "reporter": roster[0],
            }
            try:
                for w in roster:
                    slow = cfg.link_slow_factor(w)
                    self.links[w].send_json(wire.RECONFIGURE, {
                        **phase1,
                        "t_wire_s": slow * self._t_sync_wire(),
                        "t_wire_bucket_s": (
                            [slow * t for t in self._t_sync_wire_buckets()]
                            if self.boundaries else []),
                    }, wid=w)
            except (wire.WireError, OSError) as exc:
                # a member died under the broadcast: its reader surfaces
                # the loss; it drains below and the procedure restarts
                self._mark_event(-1, "reconfigure_retry", repr(exc))
            # -- collect acks (and absorb whatever else is in flight) -------
            acks: dict[int, dict] = {}
            restart = False
            while set(acks) < set(roster):
                wid, kind, detail = self._next_event(self.timeout)
                if kind == "reconf_ack":
                    if int(detail.get("epoch", -1)) == epoch:
                        acks[wid] = detail
                elif kind == "member_lost":
                    restart = True
                    break
                elif kind == "center":
                    self._p2p_center_report(*detail)   # pre-freeze report
                elif kind == "wstate":
                    self.wstate_host[wid].get(self.workers_w[wid])
                elif kind == "rejoin_hello":
                    # admitted after this reconfiguration completes (the
                    # serve loop gets it back); requeueing here would spin
                    # this very loop
                    self._pending_rejoin.append((wid, detail))
                elif kind == "ready":
                    # an admitted rejoiner finished building while this
                    # reconfiguration was in flight: it is in the roster,
                    # its ack follows
                    self.membership.mark_rejoined(wid)
                    self._mark_event(wid, "worker_rejoined",
                                     f"enters at epoch {epoch}")
                else:
                    raise RuntimeError(
                        f"protocol violation during reconfigure: "
                        f"got {kind} from worker {wid}")
            if restart:
                continue
            resume = min(int(acks[w]["round"]) for w in prev)
            # -- phase 2: the agreed resume round and the new eval cadence --
            per = p * self.tau
            last = self._last_eval
            base_iters = self._p2p_iters_at(resume - 1)
            evals = []
            for k in range(resume, self._n_sync_rounds()):
                it = base_iters + (k + 1 - resume) * per
                if it - last >= cfg.eval_every_iters:
                    evals.append(k)
                    last = it
            phase2 = {"phase": 2, "epoch": epoch, "resume_round": resume,
                      "eval_rounds": evals,
                      "upload_state": bool(joiners)}
            try:
                for w in roster:
                    self.links[w].send_json(wire.RECONFIGURE, phase2, wid=w)
                if joiners:
                    # the sync member uploads its rolled-back state; relay
                    # it to every joiner so they enter with the exact bits
                    state = None
                    while state is None:
                        wid, kind, detail = self._next_event(self.timeout)
                        if kind == "center" and detail[0] == -2:
                            state = detail[1]
                        elif kind == "center":
                            self._p2p_center_report(*detail)
                        elif kind == "member_lost":
                            restart = True
                            break
                        elif kind == "reconf_ack":
                            continue     # a stale duplicate of a restart
                        elif kind == "wstate":
                            self.wstate_host[wid].get(self.workers_w[wid])
                        elif kind == "rejoin_hello":
                            self._pending_rejoin.append((wid, detail))
                        else:
                            raise RuntimeError(
                                f"protocol violation waiting for the state "
                                f"upload: got {kind} from worker {wid}")
                    if restart:
                        continue
                    for w in joiners:
                        # raw: an exact-state transfer, never through a
                        # lossy wire codec
                        self.links[w].send_array(wire.CENTER, state,
                                                 wid=-2, raw=True)
            except (wire.WireError, OSError) as exc:
                self._mark_event(-1, "reconfigure_retry", repr(exc))
                continue
            # -- bookkeeping: the epoch turns over --------------------------
            self._epoch_iters_base = base_iters
            self._epoch_round_base = resume
            self._epoch_p = p
            self._epoch_members = set(roster)
            new_epoch = self.membership.advance_epoch()
            if new_epoch != epoch:
                raise RuntimeError(f"membership epoch {new_epoch} after "
                                   f"reconfiguring to epoch {epoch}")
            if self.live is not None:
                self.live.set_membership(roster)
            self.counters.gauge("epoch").value = epoch
            self._mark_event(
                -1, "reconfigure",
                f"epoch {epoch}: p={p} survivors={roster} "
                f"resume_round={resume}")
            for w, d in self._pending_rejoin:      # stashed mid-freeze
                self.events.put((w, "rejoin_hello", d))
            self._pending_rejoin.clear()
            return

    # -- top level -----------------------------------------------------------

    def run(self, listener: socket.socket, token: str = DEFAULT_TOKEN,
            procs: list | None = None):
        """Rendezvous → serve → clean shutdown. Returns a PSResult."""
        from repro_torch.ps.runtime import PSResult
        self._procs = procs or []
        host, port = listener.getsockname()[:2]
        if host in ("0.0.0.0", ""):
            host = "127.0.0.1"
        self._addr = f"{host}:{port}"
        try:
            self.rendezvous(listener, token)
            if self.cfg.telemetry_on:
                self._start_live()
            if self.cfg.telemetry_on or self.elastic:
                # the rendezvous listener stays open: STATS for monitors,
                # rejoin HELLOs for respawned workers
                self._start_acceptor(listener, token)
            self.serve()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            total_time = time.perf_counter() - self._t0
            self._maybe_eval(force=True)
            self._draining = True        # BYEs are expected from here on
            for link in list(self.links.values()):
                try:
                    link.send_simple(wire.DONE)
                except (wire.WireError, OSError):
                    if not self.elastic:
                        raise            # elastic: its loss drains below
            self._await("bye", set(self.links),
                        ignore=("grad", "wstate", "center", "reconf_ack"))
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
            if self.topology is not None and self.topology.hosts > 1:
                # bytes that stayed on intra-host links vs crossed hosts:
                # what hierarchical drives down
                intra_b = cross_b = 0
                for key, v in link_bytes.items():
                    i, j = (int(x) for x in key.split("-"))
                    if self.topology.host_of(i) == self.topology.host_of(j):
                        intra_b += int(v)
                    else:
                        cross_b += int(v)
                counters["intra_host_bytes"] = intra_b
                counters["cross_host_bytes"] = cross_b
            # representative per-worker stats from the lowest reporting
            # wid: under elastic membership worker 0 may not have survived
            rep = (self.bye_stats[min(self.bye_stats)]
                   if self.bye_stats else {})
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
                    if i < len(bucket_bytes):  # epochs can differ in buckets
                        bucket_bytes[i] += int(v)
            counters["bucket_send_bytes"] = bucket_bytes
        health = None
        if self.live is not None:
            health = self.live.health()
            self.live.close()
        if self.elastic:
            # PSResult.health names every death, rejoin and reconfiguration
            # on a bare (telemetry-off) run too, with the final membership
            # table and epoch; the workers' per-epoch logs and the
            # lifecycle stamps time the recovery
            if health is None:
                health = {"events": list(self._elastic_events)}
            health["membership"] = self.membership.snapshot()
            health["epoch"] = self.membership.epoch
            counters["membership_marks"] = list(self._marks)
            if self._rosters:
                counters["sync_rosters"] = [
                    [p, u, r] for (p, u), r in sorted(self._rosters.items())]
            epochs = {w: st["epochs"] for w, st in sorted(
                self.bye_stats.items()) if "epochs" in st}
            if epochs:
                counters["worker_epochs"] = epochs
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
            trace=trace, health=health)

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
    join), serve, and return the shared-memory transports' PSResult.
    ``cfg.chaos`` reaches the spawned workers as ``REPRO_CHAOS``."""
    master = MasterServer(problem, easgd, cfg, device=device,
                          join_timeout_s=join_timeout_s)
    listener = socket.socket()
    listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    listener.bind((cfg.tcp_host, cfg.tcp_port))
    listener.listen(accept_backlog(cfg.n_workers))
    port = listener.getsockname()[1]
    env_extra = None
    spec = ft_chaos.ChaosSpec.from_config(cfg.chaos)
    if spec is not None:
        env_extra = {ft_chaos.ENV_VAR: spec.to_env()}
    master._spawned_at = time.monotonic()
    procs = (spawn_local_workers(cfg.tcp_host, port, cfg.n_workers,
                                 master.device, env_extra=env_extra)
             if cfg.spawn_workers else [])
    return master.run(listener, procs=procs)

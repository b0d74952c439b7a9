"""The tcp transport's gradient worker, runnable on any host (the port of
``repro/net/worker.py``).

    PYTHONPATH=src python -m repro_torch.net.worker --connect HOST:PORT \\
        --wid 0 [--device cuda|cpu]

It imports torch, numpy, the wire and the problem factory named in the
master's WELCOME — nothing of JAX and nothing of the reference. Rows live
on ``--device`` (default: the card); frames are staged through pinned host
buffers (``wire.HostRow``), one per link and direction.

Under the master sync plane every discipline looks the same from here (the
master decides when WEIGHTS arrive):

    HELLO → WELCOME (problem spec, algorithm, τ) → build + warm-up → READY
    then per exchange:  recv WEIGHTS → [τ−1 local steps] → grad → send GRAD
    until DONE → BYE.

With τ > 1 the worker's (w, v) evolve between exchanges, so frames stack
[w|v] down and [grad|w|v] up; sync_easgd instead posts its weights
(WSTATE) before computing the exchange gradient, so the master's
all-reduce overlaps it.

Under the p2p sync plane the worker is the data plane: it opens a peer
listener before HELLO, gets the directory and the resolved rounds in
WELCOME, wires a ``net.peer.PeerMesh`` and then trains without per-round
master traffic. Each exchange runs the rounds over direct SEGMENT frames
and every worker advances its own center replica, bucket by bucket,
through the fused update kernels (``kernels.elastic_update``; their plain
versions on the CPU). The center update is in place: the kernel reads
each center element before it writes it, so ``center_out`` may be the
center itself. The master link carries worker 0's CENTER reports at the
eval rounds and one final WSTATE per worker.

A heartbeat thread sends liveness plus telemetry (iterations, rate,
exposed comm) every ``hb_interval_s``. BYE carries the kernel launch
counts of this process, which the master folds into its own, and, when
tracing, the trace payload (or its spill-file path) with the clock
estimate.

Preemption: SIGTERM / SIGINT set a flag (``ft.Watchdog``) that the loops
read at exchange boundaries; the worker then leaves with a clean BYE
(``preempted``) instead of vanishing mid-frame. ``--heartbeat-file`` is
touched every 2 s for an external supervisor. Fault injection
(``ft.chaos``, armed from ``REPRO_CHAOS``) fires at the same boundaries
and refuses the HELLO dial for a window.

Under a topology (WELCOME's ``topology``) the worker labels each peer
link ``intra`` or ``cross`` in BYE; its pacing deadlines already come
priced for its own links. ``--burn SPEC_JSON`` is the tcp calibration's
burner: build and warm up the problem, print "R", wait for a line on
stdin, time ``--samples`` gradients and print the seconds per gradient.

Elastic membership (WELCOME's ``elastic``, p2p): a control thread owns the
master link's inbound side, a failed exchange or a RECONFIGURE enters
``_recover`` (ack the freeze with the rounds completed, roll back to the
start-of-round snapshot the agreed resume round names, rewire the mesh and
its staging for the epoch's P), and ``--rejoin`` re-enters a running
elastic master from ``REPRO_CLUSTER_SPEC``. BYE then also carries a log
per epoch: P, the rounds run and the update launches made, with monotonic
stamps for the recovery clock.
"""
from __future__ import annotations

import time

_T_IMPORT = time.perf_counter()   # the worker's imports start here

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import queue  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

if __package__ in (None, ""):     # run as a file: put src on the path
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.comm.rounds import peer_pairs, rounds_from_wire  # noqa: E402
from repro_torch.core import easgd_flat  # noqa: E402
from repro_torch.ft import chaos as ft_chaos  # noqa: E402
from repro_torch.ft.watchdog import Watchdog  # noqa: E402
from repro_torch.kernels.elastic_update import (  # noqa: E402
    fused_sync_easgd_update, fused_sync_sgd_update)
from repro_torch.net import wire  # noqa: E402
from repro_torch.net.peer import MeshAbort, PeerMesh  # noqa: E402
from repro_torch.net.wire import HostRow, Link, sleep_until  # noqa: E402
from repro_torch.obs import clock as obs_clock  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402
from repro_torch.utils.device import resolve_device  # noqa: E402
from repro_torch.utils.timing import (  # noqa: E402
    Timer, stream_sync, synchronize)

SYNC = easgd_flat.SYNC_FAMILY
_IMPORT_S = time.perf_counter() - _T_IMPORT     # torch and the port


def build_problem(factory: str, kwargs, device):
    """``module:function`` + kwargs pairs -> (w0, grad_fn, eval_fn) on
    ``device``."""
    mod_name, fn_name = factory.split(":")
    fn = getattr(importlib.import_module(mod_name), fn_name)
    return fn(device=device, **dict((k, v) for k, v in kwargs))


def _drain_after_bye(link: Link, timeout_s: float = 5.0) -> None:
    """After a mid-run BYE, read (and drop) until the master hangs up:
    closing this end first with unread frames in the receive buffer would
    reset the connection and can destroy the master's unread BYE — the
    clean departure would then look like a dead socket."""
    try:
        link.sock.settimeout(timeout_s)
        while True:
            link.recv_discard(link.recv_header())
    except (OSError, wire.WireError):
        pass


def worker_loop(host: str, port: int, wid: int, token: str = "repro-net",
                timeout_s: float = 600.0, peer_host: str | None = None,
                peer_port: int = 0, sync_plane: str = "auto",
                device=None, heartbeat_file: str | None = None,
                rejoin: bool = False) -> None:
    t_start = time.perf_counter()
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    # preemption plane: SIGTERM / SIGINT set a flag the loops read at
    # exchange boundaries; the optional heartbeat file lets a supervisor
    # tell a hung interpreter from a slow one
    wd = Watchdog(heartbeat_path=heartbeat_file, interval_s=2.0)
    wd.start_heartbeat()
    chaos = ft_chaos.clock_from_env()    # inert unless REPRO_CHAOS is set
    link = Link(wire.dial_with_backoff(host, port,
                                       deadline_s=min(timeout_s, 30.0),
                                       seed=wid,
                                       refuse_fn=lambda: chaos.refuse_dial(
                                           wid)))
    link.sock.settimeout(timeout_s)
    # the peer listener binds before HELLO so its port rides in it, on the
    # interface the master link runs over unless --peer-host overrides
    local_addr = link.sock.getsockname()[0]
    mesh = (PeerMesh(wid, token, bind_host=peer_host or local_addr,
                     port=peer_port, timeout_s=timeout_s, device=dev)
            if sync_plane != "master" else None)
    hello = {"wid": wid, "token": token}
    if mesh is not None:
        hello["peer"] = [peer_host or local_addr, mesh.port]
    if rejoin:
        # respawned mid-run: the master's control acceptor answers this
        # HELLO and folds the worker in at the next epoch
        hello["rejoin"] = True
    link.send_json(wire.HELLO, hello, wid=wid)
    frame = link.recv_header()
    if frame.ftype == wire.ERROR:
        raise RuntimeError(f"master rejected us: {link.recv_json(frame)}")
    if frame.ftype != wire.WELCOME:
        raise wire.WireError(f"expected WELCOME, got {frame}")
    cfg = link.recv_json(frame)
    link.codec = wire.CODECS[cfg.get("codec", "none")]
    algo, n, tau = cfg["algorithm"], int(cfg["n"]), int(cfg["tau"])
    local_cfg = SimpleNamespace(eta=cfg["eta"], mu=cfg["mu"],
                                rho=cfg.get("rho", 0.0),
                                alpha=cfg["eta"] * cfg.get("rho", 0.0))
    velocity = easgd_flat.uses_velocity(algo) and algo not in SYNC
    p2p = cfg.get("sync_plane") == "p2p"
    if p2p and mesh is None:
        raise RuntimeError(
            "master runs sync_plane=p2p but this worker was started with "
            "--sync-plane master (no peer listener to join the mesh with)")
    if not p2p and mesh is not None:
        mesh.close()                             # advertised, never needed
        mesh = None

    # tracing rides in WELCOME; the clock handshake runs now, while the
    # link is otherwise quiet, so the rtt is measured clean
    tracing = bool(cfg.get("trace"))
    trace_dir = cfg.get("trace_dir") or None
    tr = (obs_trace.tracer("main", wid=wid, sync=stream_sync(dev))
          if tracing else None)
    clk = obs_clock.sync_over_link(link, wid=wid) if tracing else None
    telem = {"iters": 0, "rate_ips": 0.0, "exposed_s": 0.0}
    t_welcome = time.perf_counter()
    stop_hb = threading.Event()

    def _heartbeat():
        interval = float(cfg.get("hb_interval_s", 2.0))
        while not stop_hb.wait(interval):
            try:
                el = max(time.perf_counter() - t_welcome, 1e-9)
                link.send_json(wire.HEARTBEAT, {
                    "iters": telem["iters"],
                    "rate_ips": round(telem["iters"] / el, 2),
                    "exposed_s": round(telem["exposed_s"], 4),
                }, wid=wid)
            except OSError:
                return

    startup = {}

    def _bye_stats(stats: dict) -> dict:
        stats["launches"] = kernels.launch_counts()
        stats["startup_s"] = startup
        if not tracing:
            return stats
        threads = {"main": tr.spans()}
        for t in obs_trace.drain():
            if t is not tr and t.wid == wid:
                threads[t.name] = t.spans()
        payload = {"clock": clk.to_wire(), "threads": threads,
                   "dropped": tr.dropped}
        if trace_dir:
            stats["trace_file"] = obs_trace.dump_spill(trace_dir, wid,
                                                       payload)
        else:
            stats["trace"] = payload
        stats["clock"] = clk.to_wire()
        return stats

    # heartbeats from before the build: a slow build must read as alive
    hb = threading.Thread(target=_heartbeat, daemon=True)
    hb.start()
    try:
        t0 = time.perf_counter()
        w0, grad_fn, _ = build_problem(cfg["factory"], cfg["kwargs"], dev)
        w0 = w0.to(dev, torch.float64)
        t1 = time.perf_counter()
        wu = torch.zeros(n, dtype=torch.float64, device=dev)
        for k in range(int(cfg.get("warmup", 2))):   # private minibatch
            grad_fn(wu, k, -(wid + 2))               # streams ≤ −2
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        startup.update(import_s=round(_IMPORT_S, 4),
                       to_welcome_s=round(t_welcome - t_start, 4),
                       build_s=round(t1 - t0, 4),
                       warmup_s=round(time.perf_counter() - t1, 4))
        if p2p:
            _p2p_sync_loop(link, mesh, cfg, grad_fn, w0, wid, local_cfg,
                           dev, tr=tr, telem=telem, bye_wrap=_bye_stats,
                           watchdog=wd, chaos=chaos)
        else:
            _master_plane_loop(link, cfg, grad_fn, wid, local_cfg, dev,
                               velocity, tr=tr, telem=telem,
                               bye_wrap=_bye_stats, watchdog=wd,
                               chaos=chaos)
    except BaseException as exc:                 # noqa: BLE001 — tell master
        try:
            link.send_json(wire.ERROR, {"msg": repr(exc)}, wid=wid)
        except OSError:
            pass
        raise
    finally:
        stop_hb.set()
        wd.close()
        if mesh is not None:
            mesh.close()
        link.close()


def _master_plane_loop(link: Link, cfg: dict, grad_fn, wid: int, local_cfg,
                       dev, velocity: bool, tr=None, telem=None,
                       bye_wrap=None, watchdog=None, chaos=None) -> None:
    """The master plane: WEIGHTS in, GRAD (and WSTATE) out, until DONE
    (or a preemption: BYE with ``preempted``)."""
    algo, n, tau = cfg["algorithm"], int(cfg["n"]), int(cfg["tau"])
    w = torch.zeros(n, dtype=torch.float64, device=dev)
    v = torch.zeros(n, dtype=torch.float64, device=dev)
    stacked_down = velocity and tau > 1
    k_up = (3 if velocity else 2) if (tau > 1 and algo not in SYNC) else 1
    down = HostRow((2 if stacked_down else 1) * n, dev)
    up = HostRow(k_up * n, dev)
    wstate = HostRow(n, dev) if algo == "sync_easgd" and tau > 1 else None
    link.send_simple(wire.READY, wid=wid)
    step = 0
    while True:
        if watchdog is not None and watchdog.should_stop.is_set():
            # preempted: flush the stats and leave cleanly — the master
            # names it a worker_left event
            link.send_json(wire.BYE, bye_wrap(
                {"preempted": True, "iters": telem["iters"]}), wid=wid)
            _drain_after_bye(link)
            return
        if chaos is not None:
            chaos.maybe_fire(wid, step)          # deterministic fault point
        if tr is not None:
            t0 = tr.now()
        frame = link.recv_header()
        if frame.ftype == wire.DONE:
            link.recv_discard(frame)
            link.send_json(wire.BYE, bye_wrap({}), wid=wid)
            return
        if frame.ftype == wire.ERROR:
            raise RuntimeError(f"master error: {link.recv_json(frame)}")
        if frame.ftype != wire.WEIGHTS:
            raise wire.WireError(f"expected WEIGHTS, got {frame}")
        link.recv_array(frame, down.np)
        if tr is not None:
            # blocked on the master's WEIGHTS: exposed communication
            t1 = tr.now()
            tr.record(obs_trace.RECV_WAIT, t0, t1)
            telem["exposed_s"] += t1 - t0
            t0 = t1
        if stacked_down:
            down.get(w, v)
        else:
            down.get(w)
        for _ in range(tau - 1):                 # τ−1 local-only steps
            g = grad_fn(w, step, wid)
            easgd_flat.local_step(algo, w, v, g, local_cfg)
            step += 1
        if tr is not None and tau > 1:
            tr.record(obs_trace.LOCAL_STEP, t0, (t0 := tr.now()), tau - 1)
        if wstate is not None:
            # post the evolved weights first: the master's all-reduce
            # overlaps the gradient computed next
            link.send_array(wire.WSTATE, wstate.put(w), wid=wid)
        grad = grad_fn(w, step, wid)
        step += 1
        if tr is not None:
            tr.record(obs_trace.COMPUTE, t0, tr.now())
        telem["iters"] = step
        if k_up > 1:
            # one frame, each segment with its own sign-EF scale and state
            rows = (grad, w, v) if velocity else (grad, w)
            link.send_array(wire.GRAD, up.put(*rows), wid=wid,
                            segments=k_up)
        else:
            link.send_array(wire.GRAD, up.put(grad), wid=wid)


def _p2p_sync_loop(link: Link, mesh: PeerMesh, cfg: dict, grad_fn, w0,
                   wid: int, local_cfg, dev, tr=None, telem=None,
                   bye_wrap=None, watchdog=None, chaos=None) -> None:
    """The p2p sync family: this worker runs its share of the rounds over
    the peer mesh and advances its own center replica, bitwise in lockstep
    with every other worker and with the master plane.

    With ``bucket_bounds`` the exchange streams the row bucket by bucket
    and, with ``overlap``, pipelines it with compute: a comm thread runs
    the exchange on its own CUDA stream while this thread computes the
    gradient, then applies bucket b's fused update as soon as bucket b
    lands (``on_bucket``) while b + 1 is still on the wire. Bucket updates
    are elementwise on disjoint slices, so the iterates are bitwise the
    monolithic ones. ``overlap=False`` runs the same exchange inline first
    (the paper's no-overlap baseline).

    Under ``elastic`` (WELCOME, from ``PSConfig.elastic``) this loop is
    also the worker half of the membership protocol: a control thread owns
    the master link's inbound side and routes RECONFIGURE / CENTER / DONE
    / ERROR into a queue (a phase 1 also aborts the exchange in flight); a
    peer death surfaces as a failed exchange (``mesh.reset`` cascades, so
    every member falls out fast), a pure join as a flag read at the round
    boundary, and both enter ``_recover``. With ``elastic`` off none of
    this exists at run time (no thread, no snapshots)."""
    algo, n, tau = cfg["algorithm"], int(cfg["n"]), int(cfg["tau"])
    P, padded = int(cfg["p"]), int(cfg["padded"])
    n_rounds = int(cfg["n_rounds"])
    eval_rounds = set(int(k) for k in cfg["eval_rounds"])
    t_wire = float(cfg.get("t_wire_s", 0.0))
    bounds = cfg.get("bucket_bounds") or None
    overlap = bool(cfg.get("overlap", True))
    t_bucket = [float(x) for x in (cfg.get("t_wire_bucket_s") or [])]
    rounds = rounds_from_wire(cfg["rounds"])
    directory = {int(k): v for k, v in cfg["peers"].items()}
    elastic = bool(cfg.get("elastic"))
    rejoin = bool(cfg.get("rejoin"))
    reporter = 0                   # the lowest live wid reports CENTER
    mesh.codec = cfg.get("codec", "none")
    topo_wire = cfg.get("topology")
    if topo_wire and int(topo_wire.get("hosts", 1)) > 1:
        # a two-level fabric: label this worker's peer links intra / cross
        # in BYE (the pacing needs nothing here: WELCOME's t_wire_s is
        # already priced for this worker's own links)
        slots = int(topo_wire["slots"])
        mesh.host_of = lambda w: -1 if w < 0 else w // slots
    if not rejoin:
        # a rejoiner holds off: the RECONFIGURE that folds it in names the
        # epoch's geometry (WELCOME's copy is stale at the next event)
        mesh.connect(directory, peer_pairs(rounds))
        mesh.set_rounds(rounds, padded, boundaries=bounds)

    def f64(k):
        return torch.zeros(k, dtype=torch.float64, device=dev)

    w = w0.clone()                 # the same bits as the master's build
    center = w0.clone()            # the center replica (all workers agree)
    vel = f64(n)
    row = f64(padded)
    report = HostRow(n, dev)       # CENTER reports and the final WSTATE
    cuda = dev.type == "cuda"
    main_stream = torch.cuda.current_stream(dev) if cuda else None
    comm_stream = torch.cuda.Stream(dev) if cuda else None

    # -- elastic control plane: one thread owns the master link's inbound
    # side for the whole run (RECONFIGURE can land at any moment) and
    # routes frames into a queue the loop and the recovery path read
    ctrl_q: queue.SimpleQueue = queue.SimpleQueue()
    pending_reconf = [0]           # phase 1s seen, not yet consumed
    ctrl_th = None

    def _ctrl_reader():
        try:
            while True:
                frame = link.recv_header()
                if frame.ftype == wire.RECONFIGURE:
                    payload = link.recv_json(frame)
                    if payload.get("phase") == 1:
                        pending_reconf[0] += 1
                        mesh.abort()     # out of the exchange in flight
                    ctrl_q.put(("reconf", payload))
                elif frame.ftype == wire.CENTER:
                    ctrl_q.put(("center", link.recv_array(frame)))
                elif frame.ftype == wire.DONE:
                    link.recv_discard(frame)
                    ctrl_q.put(("done", None))
                    return
                elif frame.ftype == wire.ERROR:
                    ctrl_q.put(("error", link.recv_json(frame)))
                    return
                else:
                    link.recv_discard(frame)
        except (wire.WireError, OSError):
            ctrl_q.put(("dead", None))

    def _ctrl_get():
        kind, payload = ctrl_q.get(timeout=mesh.timeout_s)
        if kind == "error":
            raise RuntimeError(f"master error: {payload}")
        if kind == "dead":
            raise wire.WireError("master link died mid-run")
        return kind, payload

    if elastic:
        # started before READY: a rejoiner's READY makes the master send
        # the folding RECONFIGURE at once
        ctrl_th = threading.Thread(target=_ctrl_reader, daemon=True)
        ctrl_th.start()
    link.send_simple(wire.READY, wid=wid)        # mesh up, clock may start

    exc_box: list = []
    done_q: queue.SimpleQueue = queue.SimpleQueue()

    def _spans():
        """Update slices: bucket spans clamped to the real row (past n:
        pad)."""
        return [(a, min(b, n)) for a, b in zip(mesh.boundaries[:-1],
                                               mesh.boundaries[1:])]

    if rejoin:
        n_buckets, u_spans, pace = 0, [], None   # set by the folding epoch
    else:
        n_buckets = mesh.n_buckets
        u_spans = _spans()
        pace = t_bucket if len(t_bucket) == n_buckets else None
    comm_s = exposed_s = 0.0                     # overlap accounting
    _pc = time.perf_counter
    tr_comm = (obs_trace.tracer("comm", wid=wid, sync=tr.sync)
               if tr is not None else None)
    mesh.tracer = tr_comm                        # per-bucket wire spans
    # per-epoch log (elastic): P, the rounds run, the gradients drawn, the
    # update launches made and monotonic stamps — what the run's launch
    # counts and recovery clock are checked against. A rollback restores
    # the weights and the step, not the problem's data stream: a gradient
    # drawn for a round that is then abandoned has used up its batch
    # (grads − τ · rounds says how many such draws the epoch made)
    epochs: list = []

    def _open_epoch(epoch, start):
        epochs.append({"epoch": epoch, "p": P, "start": start, "rounds": 0,
                       "grads": 0, "updates": 0,
                       "live_buckets": sum(a < b for a, b in u_spans),
                       "t0": time.monotonic(), "t_first": None})

    if elastic and not rejoin:
        _open_epoch(0, 0)

    def _on_bucket(bidx, deadlines):
        if deadlines is not None:                # serialized-wire pacing:
            sleep_until(deadlines[bidx])         # bucket lands on schedule
        done_q.put(bidx)

    def _exchange():
        nonlocal comm_s
        t0 = tr_comm.now() if tr_comm is not None else _pc()
        ctx = (torch.cuda.stream(comm_stream) if cuda
               else contextlib.nullcontext())
        try:
            with ctx:
                start = time.monotonic()
                deadlines = ([start + sum(t_bucket[:i + 1])
                              for i in range(n_buckets)] if pace else None)
                mesh.execute_exchange(
                    row, on_bucket=lambda b: _on_bucket(b, deadlines))
                if t_wire and deadlines is None:
                    sleep_until(start + t_wire)
        except BaseException as e:               # noqa: BLE001 — re-raised
            exc_box.append(e)
            done_q.put(None)                     # unblock the update loop
        finally:
            t1 = _pc()
            comm_s += t1 - t0
            if tr_comm is not None:
                tr_comm.record(obs_trace.EXCHANGE, t0, t1)

    def _start_comm():
        if cuda:                                 # the row posted on the
            comm_stream.wait_stream(main_stream)  # main stream comes first
        th = threading.Thread(target=_exchange, daemon=True)
        th.start()
        return th

    def _apply_easgd(bidx, grad):
        a, b = u_spans[bidx]
        if a < b:
            fused_sync_easgd_update(w[a:b], grad[a:b], center[a:b],
                                    row[a:b], P, local_cfg.eta,
                                    local_cfg.rho, center_out=center[a:b])
            if epochs:
                epochs[-1]["updates"] += 1

    def _apply_sgd(bidx):
        a, b = u_spans[bidx]
        if a < b:
            fused_sync_sgd_update(center[a:b], vel[a:b], row[a:b], P,
                                  local_cfg.eta, local_cfg.mu)
            if epochs:
                epochs[-1]["updates"] += 1

    def _now():
        return tr.now() if tr is not None else _pc()

    def _drain(apply_fn):
        """Apply each bucket's update as it lands; the time blocked on the
        wire is the exposed communication this pipeline exists to hide."""
        nonlocal exposed_s
        for _ in range(n_buckets):
            t0 = _now()
            bidx = done_q.get()
            t1 = _pc()
            exposed_s += t1 - t0
            if bidx is None:
                break
            if tr is not None:
                tr.record(obs_trace.BUCKET_WAIT, t0, t1, bidx)
            apply_fn(bidx)
            if tr is not None:
                tr.record(obs_trace.UPDATE, t1, tr.now(), bidx)

    def _join_comm(comm):
        """Wait out the comm thread's tail — exposed by definition."""
        nonlocal exposed_s
        t0 = _now()
        comm.join()
        t1 = _pc()
        exposed_s += t1 - t0
        if tr is not None:
            tr.record(obs_trace.COMM_WAIT, t0, t1)

    def _exchange_inline():
        """No-overlap baseline: the whole wire is exposed."""
        nonlocal exposed_s
        t0 = _now()
        _start_comm().join()
        t1 = _pc()
        exposed_s += t1 - t0
        if tr is not None:
            tr.record(obs_trace.COMM_WAIT, t0, t1)

    def _grad_traced(step):
        t0 = _now()
        g = grad_fn(w, step, wid)
        if epochs:
            epochs[-1]["grads"] += 1
        if tr is not None:
            tr.record(obs_trace.COMPUTE, t0, tr.now())
        return g

    # start-of-round snapshot ring, 2 deep (elastic only): the agreed
    # resume round is the minimum over the acks, and the all-reduce bounds
    # the spread of completed rounds to 1 (a worker finishes exchange k
    # only once every peer has entered it), so a rollback needs at most
    # the previous boundary
    snaps: dict = {}
    cur_epoch = 0
    state_host = None              # the state upload to a joiner

    def _recover(rounds_done, step_now, failed, first_p1=None,
                 joiner=False):
        """The worker half of the two-phase reconfiguration (see
        server.py's ``_reconfigure_p2p``): tear the mesh down, ack phase 1
        with the rounds completed, adopt phase 2's resume round (rolling
        back to its snapshot — or, for a joiner, taking the state the
        master relays), rewire the mesh and its staging to the new epoch's
        geometry, and return (resume, step)."""
        nonlocal P, padded, n_rounds, rounds, row, u_spans, n_buckets, \
            pace, t_wire, t_bucket, eval_rounds, reporter, cur_epoch, \
            state_host
        if cuda:                 # the comm stream's and the updates' work
            torch.cuda.synchronize(dev)          # done before state is read
        if epochs:
            epochs[-1].update(end=rounds_done, t1=time.monotonic())
        p1 = first_p1
        while True:
            mesh.reset()                 # closes the peer links: every
            exc_box.clear()              # member still in the doomed
            while True:                  # exchange falls out at once
                try:
                    done_q.get_nowait()
                except queue.Empty:
                    break
            while p1 is None:
                kind, payload = _ctrl_get()
                if kind == "done":
                    raise RuntimeError("master finished mid-reconfigure")
                if kind == "reconf" and payload.get("phase") == 1:
                    pending_reconf[0] -= 1
                    p1 = payload
            p2 = None
            while p2 is None:
                link.send_json(wire.RECONFIGURE,
                               {"epoch": int(p1["epoch"]),
                                "round": rounds_done,
                                "step": step_now}, wid=wid)
                while True:
                    kind, payload = _ctrl_get()
                    if kind == "done":
                        raise RuntimeError(
                            "master finished mid-reconfigure")
                    if kind != "reconf":
                        continue
                    if payload.get("phase") == 1:
                        # another loss mid-handshake: the master restarted
                        # with a smaller roster — ack the fresh epoch
                        pending_reconf[0] -= 1
                        p1 = payload
                        break
                    if int(payload.get("epoch", -1)) == int(p1["epoch"]):
                        p2 = payload
                        break
            resume = int(p2["resume_round"])
            if pending_reconf[0] > 0:
                # a fresh phase 1 is queued already (a loss after phase 2
                # went out): do not wire a doomed mesh, start over
                p1 = None
                continue
            # -- state: roll back, upload, or adopt -------------------------
            if joiner:
                arr = None
                while arr is None:
                    kind, payload = _ctrl_get()
                    if kind == "center":     # the relayed member's state
                        arr = payload
                    elif kind == "done":
                        raise RuntimeError(
                            "master finished mid-reconfigure")
                center.copy_(torch.from_numpy(arr[:n]))
                if arr.size >= 2 * n:
                    vel.copy_(torch.from_numpy(arr[n:2 * n]))
                else:
                    vel.zero_()
                w.copy_(center)
                step_now = resume * tau  # the survivors' step at resume
            else:
                if failed or resume != rounds_done:
                    try:
                        sw, sv, sc, sstep = snaps[resume]
                    except KeyError:
                        raise RuntimeError(
                            f"elastic: no snapshot for resume round "
                            f"{resume} (have {sorted(snaps)})") from None
                    w.copy_(sw)
                    vel.copy_(sv)
                    center.copy_(sc)
                    step_now = sstep
                if p2.get("upload_state") and wid == int(p1["sync_wid"]):
                    # the lowest previous member ships the rolled-back
                    # state, so joiners enter with the exact center (and
                    # velocity) bits
                    rows = ((center,) if algo == "sync_easgd"
                            else (center, vel))
                    if state_host is None:
                        state_host = HostRow(len(rows) * n, dev)
                    link.send_array(wire.CENTER, state_host.put(*rows),
                                    wid=-2, raw=True)
            # -- adopt the new epoch's geometry -----------------------------
            cur_epoch = int(p1["epoch"])
            P, padded = int(p1["p"]), int(p1["padded"])
            n_rounds = int(p1["n_rounds"])
            rounds = rounds_from_wire(p1["rounds"])
            t_wire = float(p1.get("t_wire_s", 0.0))
            t_bucket = [float(x) for x in (p1.get("t_wire_bucket_s") or [])]
            eval_rounds = set(int(x) for x in p2["eval_rounds"])
            reporter = int(p1["reporter"])
            row = f64(padded)            # the epoch's padding, on the device
            if resume < n_rounds:        # exchanges remain: rewire
                mesh.reset()             # no links here; clears an abort
                new_dir = {int(x): a for x, a in p1["peers"].items()}
                mesh.connect(new_dir, peer_pairs(rounds))
                mesh.set_rounds(rounds, padded,
                                boundaries=p1.get("bucket_bounds") or None)
                n_buckets = mesh.n_buckets
                u_spans = _spans()
                pace = t_bucket if len(t_bucket) == n_buckets else None
            snaps.clear()                # pre-epoch snapshots are stale
            if epochs:
                epochs[-1]["resume_next"] = resume
            _open_epoch(cur_epoch, resume)
            return resume, step_now

    step = 0
    k = 0
    if rejoin:
        # a respawn enters through recovery: it acks round −1 (it is no
        # previous-epoch member, so its ack never bounds the resume round),
        # takes the relayed state, and starts at the resume round
        k, step = _recover(-1, 0, failed=False, joiner=True)
    reported_final = False
    while True:
        while k < n_rounds:
            if elastic:
                snaps[k] = (w.clone(), vel.clone(), center.clone(), step)
                snaps.pop(k - 2, None)
                if pending_reconf[0] > 0:        # a join (no death) folds
                    k, step = _recover(k, step, failed=False)  # in here,
                    continue                     # at the round boundary
            if watchdog is not None and watchdog.should_stop.is_set():
                # preempted between rounds: the mesh is safe to leave only
                # at a round boundary (peers block on our segments
                # mid-exchange)
                stats = {"preempted": True, "iters": step}
                if epochs:
                    epochs[-1].update(end=k, t1=time.monotonic())
                    stats["epochs"] = epochs
                link.send_json(wire.BYE, bye_wrap(stats), wid=wid)
                if ctrl_th is not None:
                    ctrl_th.join(timeout=5.0)    # ends when master hangs up
                else:
                    _drain_after_bye(link)
                return
            if chaos is not None:
                chaos.maybe_fire(wid, step)      # deterministic fault point
            try:
                if tau > 1:
                    t0 = _now()
                    for _ in range(tau - 1):     # τ−1 local-only steps
                        g = grad_fn(w, step, wid)
                        if epochs:
                            epochs[-1]["grads"] += 1
                        easgd_flat.local_step(algo, w, vel, g, local_cfg)
                        step += 1
                    if tr is not None:
                        tr.record(obs_trace.LOCAL_STEP, t0, tr.now(),
                                  tau - 1)
                if algo == "sync_easgd":
                    row[:n].copy_(w)             # start-of-exchange weights
                    if overlap:
                        comm = _start_comm()     # buckets fly while the
                        grad = _grad_traced(step)    # gradient computes
                        step += 1
                        _drain(lambda b: _apply_easgd(b, grad))
                        _join_comm(comm)
                    else:
                        _exchange_inline()
                        grad = _grad_traced(step)
                        step += 1
                        _drain(lambda b: _apply_easgd(b, grad))
                else:                            # sync_sgd: grads first, so
                    grad = _grad_traced(step)    # only the per-bucket
                    step += 1                    # master update overlaps
                    row[:n].copy_(grad)
                    if overlap:
                        comm = _start_comm()
                        _drain(_apply_sgd)
                        _join_comm(comm)
                    else:
                        _exchange_inline()
                        _drain(_apply_sgd)
                if exc_box:
                    raise exc_box[0]
                if algo != "sync_easgd":
                    w.copy_(center)
                telem["iters"] = step
                telem["exposed_s"] = exposed_s
                telem["comm_s"] = comm_s
                if wid == reporter and k in eval_rounds:
                    # control-plane reports go raw even under wire
                    # compression (one-shot exact state), tagged with the
                    # exchange round: reports and reconfigurations
                    # interleave
                    link.send_array(wire.CENTER, report.put(center), wid=k,
                                    raw=True)
            except (wire.WireError, OSError, MeshAbort):
                if not elastic:
                    raise
                # a peer died (or a RECONFIGURE aborted the exchange): the
                # exchange collapsed under us — freeze, ack the rounds
                # completed, resume in the reconfigured epoch
                k, step = _recover(k, step, failed=True)
                continue
            if epochs:
                ep = epochs[-1]
                ep["rounds"] += 1
                if ep["t_first"] is None:
                    if cuda:             # the round's updates have landed
                        torch.cuda.current_stream(dev).synchronize()
                    ep["t_first"] = time.monotonic()
            k += 1
        # -- final reports: the tagged center (−1) and this worker's weights
        if epochs:
            epochs[-1].update(end=k, t1=time.monotonic())
        if wid == reporter and not reported_final:
            link.send_array(wire.CENTER, report.put(center), wid=-1,
                            raw=True)
            reported_final = True
        link.send_array(wire.WSTATE, report.put(w), wid=wid, raw=True)
        stats = mesh.stats()
        stats.update({"comm_s": comm_s, "exposed_s": exposed_s,
                      "overlapped_s": max(0.0, comm_s - exposed_s),
                      "overlap": overlap})
        if mesh.host_of is not None:
            stats["host"] = mesh.host_of(wid)
        if elastic:
            stats["epoch"] = cur_epoch
            stats["epochs"] = epochs
        stats = bye_wrap(stats)
        if not elastic:
            while True:                          # control plane: DONE → BYE
                frame = link.recv_header()
                if frame.ftype == wire.DONE:
                    link.recv_discard(frame)
                    link.send_json(wire.BYE, stats, wid=wid)
                    return
                if frame.ftype == wire.ERROR:
                    raise RuntimeError(
                        f"master error: {link.recv_json(frame)}")
                link.recv_discard(frame)
        recovered = False
        while not recovered:                     # elastic: DONE → BYE, via
            kind, payload = _ctrl_get()          # the control thread
            if kind == "done":
                link.send_json(wire.BYE, stats, wid=wid)
                return
            if kind == "reconf" and payload.get("phase") == 1:
                # a member died in the final drain, before the last CENTER
                # landed: every exchange completed everywhere (resume ==
                # n_rounds) but the reporter may have changed — recover,
                # loop back and report again (the master folds duplicate
                # reports)
                pending_reconf[0] -= 1
                k, step = _recover(k, step, failed=False, first_p1=payload)
                reported_final = False
                recovered = True


def burn_main(spec_json: str, samples: int, wid: int, device) -> None:
    """Calibration burner: this interpreter, with a worker's imports,
    times its own gradients while its siblings do the same
    (``ps.calibrate`` on tcp takes the median). Protocol: build and warm
    up, print "R", wait for a line on stdin (the gate), run ``samples``
    gradients, print the seconds per gradient."""
    spec = json.loads(spec_json)
    dev = resolve_device(device)
    w0, grad_fn, _ = build_problem(spec["factory"], spec["kwargs"], dev)
    w = w0.to(dev, torch.float64).clone()
    for k in range(5):
        grad_fn(w, k, -(wid + 2))
    synchronize(dev)
    print("R", flush=True)
    sys.stdin.readline()
    with Timer(dev) as tm:
        for k in range(samples):
            grad_fn(w, k, -(wid + 2))
    print(tm.elapsed / samples, flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--connect", default=None, metavar="HOST:PORT")
    ap.add_argument("--wid", type=int, default=-1,
                    help="worker id (default: from REPRO_CLUSTER_SPEC)")
    ap.add_argument("--token", default="repro-net")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default, or REPRO_CLUSTER_SPEC's "
                         "device; an error without a GPU) or cpu")
    ap.add_argument("--sync-plane", default="auto",
                    choices=["auto", "master", "p2p"],
                    help="auto/p2p: open a peer listener and advertise it "
                         "in HELLO (the master's WELCOME decides whether "
                         "the p2p data plane is used); master: skip it")
    ap.add_argument("--peer-port", type=int, default=0,
                    help="fixed bind port for the peer listener (multi-host "
                         "p2p behind firewalls; 0 = ephemeral)")
    ap.add_argument("--peer-host", default=None,
                    help="address to advertise for the peer listener "
                         "(default: the local end of the master link)")
    ap.add_argument("--heartbeat-file", default=None,
                    help="touch this file every ~2 s so an external "
                         "supervisor can tell a hung worker "
                         "(ft.Watchdog.is_alive)")
    ap.add_argument("--rejoin", action="store_true",
                    help="rejoin a running elastic master mid-run (a "
                         "respawn is a re-exec with REPRO_CLUSTER_SPEC "
                         "set plus this flag)")
    ap.add_argument("--burn", default=None, metavar="SPEC_JSON",
                    help="calibration mode: time this interpreter's "
                         "gradients while its siblings run, instead of "
                         "training")
    ap.add_argument("--samples", type=int, default=20)
    args = ap.parse_args(argv)
    if args.burn is not None:
        burn_main(args.burn, args.samples, args.wid, args.device or "cuda")
        return
    # the declarative spec (server.cluster_spec_env) fills any connection
    # detail the command line leaves out
    spec = os.environ.get("REPRO_CLUSTER_SPEC")
    if spec:
        spec = json.loads(spec)
        if args.connect is None:
            args.connect = f"{spec['host']}:{spec['port']}"
        if args.wid < 0:
            args.wid = int(spec["wid"])
        if args.token == "repro-net" and "token" in spec:
            args.token = spec["token"]
        if args.sync_plane == "auto" and "sync_plane" in spec:
            args.sync_plane = spec["sync_plane"]
        if args.peer_port == 0 and "peer_port" in spec:
            args.peer_port = int(spec["peer_port"])
        if args.device is None and "device" in spec:
            args.device = spec["device"]
    if args.connect is None:
        ap.error("--connect is required (unless --burn or "
                 "REPRO_CLUSTER_SPEC is set)")
    if args.wid < 0:
        ap.error("--wid is required (unless REPRO_CLUSTER_SPEC names it)")
    host, port = args.connect.rsplit(":", 1)
    worker_loop(host, int(port), args.wid, token=args.token,
                timeout_s=args.timeout, peer_host=args.peer_host,
                peer_port=args.peer_port, sync_plane=args.sync_plane,
                device=args.device or "cuda",
                heartbeat_file=args.heartbeat_file, rejoin=args.rejoin)


if __name__ == "__main__":
    main()

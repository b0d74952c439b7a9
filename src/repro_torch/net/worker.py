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
from repro_torch.kernels.elastic_update import (  # noqa: E402
    fused_sync_easgd_update, fused_sync_sgd_update)
from repro_torch.net import wire  # noqa: E402
from repro_torch.net.peer import PeerMesh  # noqa: E402
from repro_torch.net.wire import HostRow, Link, sleep_until  # noqa: E402
from repro_torch.obs import clock as obs_clock  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402
from repro_torch.utils.device import resolve_device  # noqa: E402
from repro_torch.utils.timing import stream_sync  # noqa: E402

SYNC = easgd_flat.SYNC_FAMILY
_IMPORT_S = time.perf_counter() - _T_IMPORT     # torch and the port


def build_problem(factory: str, kwargs, device):
    """``module:function`` + kwargs pairs -> (w0, grad_fn, eval_fn) on
    ``device``."""
    mod_name, fn_name = factory.split(":")
    fn = getattr(importlib.import_module(mod_name), fn_name)
    return fn(device=device, **dict((k, v) for k, v in kwargs))


def worker_loop(host: str, port: int, wid: int, token: str = "repro-net",
                timeout_s: float = 600.0, peer_host: str | None = None,
                peer_port: int = 0, sync_plane: str = "auto",
                device=None) -> None:
    t_start = time.perf_counter()
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    link = Link(wire.dial_with_backoff(host, port,
                                       deadline_s=min(timeout_s, 30.0),
                                       seed=wid))
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
                           dev, tr=tr, telem=telem, bye_wrap=_bye_stats)
        else:
            _master_plane_loop(link, cfg, grad_fn, wid, local_cfg, dev,
                               velocity, tr=tr, telem=telem,
                               bye_wrap=_bye_stats)
    except BaseException as exc:                 # noqa: BLE001 — tell master
        try:
            link.send_json(wire.ERROR, {"msg": repr(exc)}, wid=wid)
        except OSError:
            pass
        raise
    finally:
        stop_hb.set()
        if mesh is not None:
            mesh.close()
        link.close()


def _master_plane_loop(link: Link, cfg: dict, grad_fn, wid: int, local_cfg,
                       dev, velocity: bool, tr=None, telem=None,
                       bye_wrap=None) -> None:
    """The master plane: WEIGHTS in, GRAD (and WSTATE) out, until DONE."""
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
                   bye_wrap=None) -> None:
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
    (the paper's no-overlap baseline)."""
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
    mesh.codec = cfg.get("codec", "none")
    mesh.connect(directory, peer_pairs(rounds))
    mesh.set_rounds(rounds, padded, boundaries=bounds)

    w = w0.clone()                 # the same bits as the master's build
    center = w0.clone()            # the center replica (all workers agree)
    vel = torch.zeros(n, dtype=torch.float64, device=dev)
    row = torch.zeros(padded, dtype=torch.float64, device=dev)
    report = HostRow(n, dev)       # CENTER reports and the final WSTATE
    cuda = dev.type == "cuda"
    main_stream = torch.cuda.current_stream(dev) if cuda else None
    comm_stream = torch.cuda.Stream(dev) if cuda else None
    link.send_simple(wire.READY, wid=wid)        # mesh up, clock may start

    exc_box: list = []
    done_q: queue.SimpleQueue = queue.SimpleQueue()
    n_buckets = mesh.n_buckets
    # update slices: bucket spans clamped to the real row (past n: pad)
    u_spans = [(a, min(b, n)) for a, b in zip(mesh.boundaries[:-1],
                                              mesh.boundaries[1:])]
    pace = t_bucket if len(t_bucket) == n_buckets else None
    comm_s = exposed_s = 0.0                     # overlap accounting
    _pc = time.perf_counter
    tr_comm = (obs_trace.tracer("comm", wid=wid, sync=tr.sync)
               if tr is not None else None)
    mesh.tracer = tr_comm                        # per-bucket wire spans

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

    def _apply_sgd(bidx):
        a, b = u_spans[bidx]
        if a < b:
            fused_sync_sgd_update(center[a:b], vel[a:b], row[a:b], P,
                                  local_cfg.eta, local_cfg.mu)

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
        if tr is not None:
            tr.record(obs_trace.COMPUTE, t0, tr.now())
        return g

    step = 0
    for k in range(n_rounds):
        if tau > 1:
            t0 = _now()
            for _ in range(tau - 1):             # τ−1 local-only steps
                g = grad_fn(w, step, wid)
                easgd_flat.local_step(algo, w, vel, g, local_cfg)
                step += 1
            if tr is not None:
                tr.record(obs_trace.LOCAL_STEP, t0, tr.now(), tau - 1)
        if algo == "sync_easgd":
            row[:n].copy_(w)                     # start-of-exchange weights
            if overlap:
                comm = _start_comm()             # buckets fly while the
                grad = _grad_traced(step)        # gradient computes
                step += 1
                _drain(lambda b: _apply_easgd(b, grad))
                _join_comm(comm)
            else:
                _exchange_inline()
                grad = _grad_traced(step)
                step += 1
                _drain(lambda b: _apply_easgd(b, grad))
        else:                                    # sync_sgd: grads first, so
            grad = _grad_traced(step)            # only the per-bucket
            step += 1                            # master update overlaps
            row[:n].copy_(grad)
            if overlap:
                comm = _start_comm()
                _drain(_apply_sgd)
                _join_comm(comm)
            else:
                _exchange_inline()
                _drain(_apply_sgd)
            w.copy_(center)
        if exc_box:
            raise exc_box[0]
        telem["iters"] = step
        telem["exposed_s"] = exposed_s
        telem["comm_s"] = comm_s
        if wid == 0 and k in eval_rounds:
            # control-plane reports go raw even under wire compression
            # (one-shot exact state), tagged with the exchange round
            link.send_array(wire.CENTER, report.put(center), wid=k,
                            raw=True)
    # -- final reports: the tagged center (−1) and this worker's weights ----
    if wid == 0:
        link.send_array(wire.CENTER, report.put(center), wid=-1, raw=True)
    link.send_array(wire.WSTATE, report.put(w), wid=wid, raw=True)
    stats = mesh.stats()
    stats.update({"comm_s": comm_s, "exposed_s": exposed_s,
                  "overlapped_s": max(0.0, comm_s - exposed_s),
                  "overlap": overlap})
    stats = bye_wrap(stats)
    while True:                                  # control plane: DONE → BYE
        frame = link.recv_header()
        if frame.ftype == wire.DONE:
            link.recv_discard(frame)
            link.send_json(wire.BYE, stats, wid=wid)
            return
        if frame.ftype == wire.ERROR:
            raise RuntimeError(f"master error: {link.recv_json(frame)}")
        link.recv_discard(frame)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--connect", default=None, metavar="HOST:PORT")
    ap.add_argument("--wid", type=int, default=-1,
                    help="worker id (default: from REPRO_CLUSTER_SPEC)")
    ap.add_argument("--token", default="repro-net")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; an error without a GPU) or cpu")
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
    args = ap.parse_args(argv)
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
    if args.connect is None:
        ap.error("--connect is required (unless REPRO_CLUSTER_SPEC is set)")
    if args.wid < 0:
        ap.error("--wid is required (unless REPRO_CLUSTER_SPEC names it)")
    host, port = args.connect.rsplit(":", 1)
    worker_loop(host, int(port), args.wid, token=args.token,
                timeout_s=args.timeout, peer_host=args.peer_host,
                peer_port=args.peer_port, sync_plane=args.sync_plane,
                device=args.device)


if __name__ == "__main__":
    main()

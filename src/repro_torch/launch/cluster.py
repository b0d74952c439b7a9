"""Cluster launcher for the PS runtime over the tcp transport (the port of
``repro/launch/cluster.py``).

Localhost (spawns the worker processes itself, on ``--device``):

    PYTHONPATH=src python -m repro_torch.launch.cluster --workers 4 \\
        --algorithm sync_easgd --schedule ring --iters 400

Multi-host: the master binds a fixed port and waits; each worker host runs
the printed one-liner (or pass --ssh to have this process run them):

    PYTHONPATH=src python -m repro_torch.launch.cluster --workers 4 \\
        --algorithm async_easgd --hosts h1,h2 --port 29500

    # printed for each wid, round robin over --hosts:
    #   PYTHONPATH=src python -m repro_torch.net.worker \\
    #       --connect <master>:29500 --wid 0 --token repro-net --device cuda

Rendezvous: the master accepts until all P workers said HELLO, ships each
the problem factory, algorithm and τ in WELCOME, and starts the clock only
after every worker reported READY (problem built, warmed up). Heartbeats
tell a slow gradient from a dead host; DONE / BYE shut down.
``--compression sign_ef`` puts 1-bit sign + error-feedback payloads on
every link.

``--sync-plane p2p`` (sync family): the workers execute the schedule's
rounds over worker↔worker links and the master only coordinates. With
--hosts the printed one-liners pin each peer listener to --port+1+wid, so
the p2p mesh is firewall-predictable:

    PYTHONPATH=src python -m repro_torch.launch.cluster --workers 4 \\
        --algorithm sync_easgd --schedule ring --sync-plane p2p \\
        --hosts h1,h2 --port 29500

``--telemetry`` / ``--telemetry-jsonl PATH`` turn the live plane on (the
run ends with a ``# health: N event(s)`` report; with a pinned --port,
``python -m repro_torch.launch.monitor --connect`` watches it), and
``--elastic`` makes a worker's death a RECONFIGURE epoch instead of a dead
run (with --hosts each worker also gets a respawn one-liner that re-execs
it from its ``REPRO_CLUSTER_SPEC``). ``--heartbeat-file`` is touched every
2 s while the master runs.
"""
from __future__ import annotations

import argparse
import dataclasses
import shlex
import socket
import subprocess
import sys
from pathlib import Path

if __package__ in (None, ""):     # run as a file: put src on the path
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from repro_torch.comm import schedules as comm_schedules  # noqa: E402


def _advertised_addr(port: int) -> str:
    try:
        host = socket.gethostbyname(socket.gethostname())
    except OSError:
        host = socket.gethostname()
    return f"{host}:{port}"


def main(argv=None):
    from repro_torch import kernels
    from repro_torch.core import costmodel
    from repro_torch.core.async_engine import ALGORITHMS
    from repro_torch.core.easgd import EASGDConfig
    from repro_torch.core.easgd_flat import SYNC_FAMILY
    from repro_torch.launch.train import report_trace
    from repro_torch.net.server import cluster_spec_env, worker_command
    from repro_torch.ps import runtime, zoo

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--algorithm", default="sync_easgd",
                    help="one of core.async_engine.ALGORITHMS, or 'all'")
    ap.add_argument("--transport", default="tcp",
                    choices=["tcp", "thread", "process"],
                    help="tcp is the point of this launcher; the "
                         "shared-memory transports are accepted for "
                         "side-by-side runs")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; an error without a GPU) or cpu; "
                         "spawned workers run on the same device")
    ap.add_argument("--schedule", default="ring",
                    choices=list(comm_schedules.names()) + ["auto"])
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--eval-every", type=int, default=200)
    ap.add_argument("--eta", type=float, default=0.1)
    ap.add_argument("--rho", type=float, default=0.1)
    ap.add_argument("--tau", type=int, default=1,
                    help="communication period: τ−1 local steps per exchange")
    ap.add_argument("--compression", default="none",
                    choices=["none", "sign_ef"],
                    help="per-link wire codec (sign_ef: 1 bit/element + "
                         "error feedback)")
    ap.add_argument("--sync-plane", default="master",
                    choices=["master", "p2p"],
                    help="sync-family data plane: 'master' runs the "
                         "all-reduce at the master (Θ(P·N) through its "
                         "links a round); 'p2p' has the workers run the "
                         "rounds over worker↔worker links")
    ap.add_argument("--emulate", default="none", choices=["wire", "none"],
                    help="'wire': deadline-pace every message under "
                         "costmodel.PS_WIRE on top of the real socket")
    ap.add_argument("--hosts", default=None,
                    help="comma-separated worker hosts; the master binds "
                         "0.0.0.0:--port and waits for them (omit: spawn "
                         "localhost workers)")
    ap.add_argument("--port", type=int, default=None,
                    help="fixed rendezvous port (default: 29500 with "
                         "--hosts, ephemeral for localhost runs)")
    ap.add_argument("--ssh", action="store_true",
                    help="with --hosts: run the printed worker commands "
                         "over ssh instead of only printing them")
    ap.add_argument("--model", default="tiny-mlp",
                    help="training problem (ps.zoo): tiny-mlp (default), "
                         "mlp, mlp-large, lenet, alexnet, gemma3-4b or "
                         "mamba2-780m (the reduced LMs)")
    ap.add_argument("--bucket-bytes", type=int, default=0,
                    help="sync family: bucket the exchange into ~this many "
                         "payload bytes per bucket at layer edges (0 = "
                         "monolithic). On the p2p plane buckets stream "
                         "while compute runs")
    ap.add_argument("--no-overlap", action="store_true",
                    help="p2p: run the bucketed exchange before the "
                         "gradient (the no-overlap baseline; the same bits)")
    ap.add_argument("--trace", action="store_true",
                    help="record spans on every worker and the master, "
                         "merge them onto the master clock, write "
                         "trace-<algo>-tcp.json (Perfetto) and print the "
                         "Table-3 shares")
    ap.add_argument("--trace-dir", default=None,
                    help="directory for worker trace spills and the merged "
                         "trace (implies --trace); spills are written on "
                         "the worker's filesystem")
    ap.add_argument("--telemetry", action="store_true",
                    help="turn on the live plane (obs.live): per-worker "
                         "heartbeat time series, the online straggler / "
                         "health detector, and the STATS frame that "
                         "`python -m repro_torch.launch.monitor` renders")
    ap.add_argument("--telemetry-jsonl", default=None, metavar="PATH",
                    help="stream one JSON line per telemetry sample to "
                         "PATH (implies --telemetry)")
    ap.add_argument("--heartbeat-file", default=None, metavar="PATH",
                    help="touch PATH every ~2 s while the run is alive so "
                         "an external supervisor can tell a hung master "
                         "(ft.Watchdog.is_alive PATH)")
    ap.add_argument("--elastic", action="store_true",
                    help="elastic membership (ft.membership): a worker "
                         "death freezes the superstep, the survivors are "
                         "RECONFIGUREd onto a re-resolved schedule, and a "
                         "respawned worker rejoins at the next epoch")
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)

    if args.compression != "none" and args.transport != "tcp":
        ap.error("--compression is a tcp wire feature; the shared-memory "
                 "transports move no frames")
    if args.sync_plane == "p2p" and args.transport != "tcp":
        ap.error("--sync-plane p2p is a tcp feature: the p2p data plane is "
                 "worker↔worker sockets")
    if args.elastic and args.transport != "tcp":
        ap.error("--elastic reconfigures real links (tcp only)")
    algos = list(ALGORITHMS) if args.algorithm == "all" else [args.algorithm]
    if args.sync_plane == "p2p":
        bad = [a for a in algos if a not in SYNC_FAMILY]
        if bad:
            ap.error(f"--sync-plane p2p applies to the sync family only; "
                     f"{bad} exchange through the master by definition")
    easgd = EASGDConfig(eta=args.eta, rho=args.rho, mu=0.9, tau=args.tau)
    multi_host = bool(args.hosts)
    port = args.port if args.port is not None else (29500 if multi_host
                                                    else 0)
    problem = zoo.resolve(args.model)
    base = runtime.PSConfig(
        algorithm=algos[0], n_workers=args.workers,
        transport=args.transport, schedule=args.schedule,
        total_iters=args.iters, eval_every_iters=args.eval_every,
        emulate_net=costmodel.PS_WIRE if args.emulate == "wire" else None,
        wire_compression=args.compression,
        tcp_host="0.0.0.0" if multi_host else "127.0.0.1",
        tcp_port=port, spawn_workers=not multi_host,
        sync_plane=args.sync_plane, bucket_bytes=args.bucket_bytes,
        overlap=not args.no_overlap,
        trace=args.trace or bool(args.trace_dir), trace_dir=args.trace_dir,
        telemetry=args.telemetry, telemetry_jsonl=args.telemetry_jsonl,
        elastic=args.elastic)
    if port and args.transport == "tcp" and (args.telemetry
                                             or args.telemetry_jsonl):
        print(f"# telemetry: watch with  PYTHONPATH=src python -m "
              f"repro_torch.launch.monitor --connect 127.0.0.1:{port} "
              f"--follow", flush=True)
    watchdog = None
    if args.heartbeat_file:
        from repro_torch.ft.watchdog import Watchdog
        watchdog = Watchdog(heartbeat_path=args.heartbeat_file,
                            install_signals=False, interval_s=2.0)
        watchdog.start_heartbeat()

    results = []
    for algo in algos:
        cfg = dataclasses.replace(base, algorithm=algo)
        ssh_procs = []
        if multi_host:
            hosts = [h for h in args.hosts.split(",") if h]
            addr = _advertised_addr(port)
            p2p = args.sync_plane == "p2p"
            note = (f" (p2p data plane: peer listeners bind ports "
                    f"{port + 1}..{port + args.workers})" if p2p else "")
            print(f"# master: {algo} on {addr} "
                  f"sync_plane={args.sync_plane}{note}; start each worker:")
            for wid in range(args.workers):
                host = hosts[wid % len(hosts)]
                cmd = worker_command(
                    addr, wid, sync_plane=args.sync_plane if p2p else None,
                    peer_port=port + 1 + wid if p2p else None,
                    device=args.device)
                print(f"#   [{host}] {cmd}")
                if args.elastic:
                    # a respawn is a re-exec from the declarative spec,
                    # not a hand-made command line
                    mhost, mport = addr.rsplit(":", 1)
                    spec = cluster_spec_env(
                        "worker", wid, mhost, int(mport),
                        sync_plane=args.sync_plane if p2p else None,
                        peer_port=port + 1 + wid if p2p else None,
                        device=args.device)
                    print(f"#   [{host}] respawn: "
                          f"REPRO_CLUSTER_SPEC={shlex.quote(spec)} "
                          f"PYTHONPATH=src python -m repro_torch.net.worker "
                          f"--rejoin")
                if args.ssh:
                    ssh_procs.append(subprocess.Popen(
                        ["ssh", host, *shlex.split(cmd)]))
        kernels.reset_launch_counts()
        try:
            res = runtime.run_ps(problem, easgd, cfg, device=args.device,
                                 join_timeout_s=args.timeout)
        finally:
            for proc in ssh_procs:
                proc.terminate()
        print(f"{algo:16s} [{res.transport}/{res.schedule}@{res.device}] "
              f"iters={res.total_iters} err={res.final_metric:.3f} "
              f"time={res.total_time_s:.2f}s counters={res.counters} "
              f"launches={kernels.launch_counts()}", flush=True)
        if res.health is not None:
            n_ev = len(res.health.get("events", []))
            flagged = res.health.get("flagged", {})
            print(f"# health: {n_ev} event(s)"
                  + (f", flagged={flagged}" if flagged else "")
                  + (f", jsonl={args.telemetry_jsonl}"
                     if args.telemetry_jsonl else ""), flush=True)
            for ev in res.health.get("events", [])[-5:]:
                print(f"#   {ev}", flush=True)
        if res.trace is not None:
            report_trace(res, algo, args.trace_dir)
        results.append(res)
    if watchdog is not None:
        watchdog.close()
    return results


if __name__ == "__main__":
    main()

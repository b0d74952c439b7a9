"""Training entry point of the port (the port of ``repro/launch/train.py``).

``--mode sync`` (the default) runs the packed multi-pod Sync EASGD step
(``runtime.train.build_train_step``) on the data pipeline, with
checkpoints and the preemption watchdog:

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-4b \\
        --reduced --n-pods 2 --steps 12 --batch 8 --seq 32 --device cpu

It places the step on a mesh of the world it was launched in: one process
(a world of one), or ``torchrun``'s (``--nproc-per-node N``, one card a
process over NCCL, or ``--device cpu`` over gloo):

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch gemma3-4b --reduced --n-pods 2 --steps 12 --batch 8 --seq 32

with the reference's rule: ``(pod, data, model) = (n_pods, world /
n_pods, 1)`` when ``n_pods`` divides the world, else ``(world, 1, 1)``
with ``n_pods / world`` pods on each rank. Rank 0 prints, and writes the
checkpoints (whole tensors gathered from the ranks, as the reference's
manager writes whole arrays); every rank restores them and keeps its
block.

It prints the reference's lines (the ``exchange:`` banner, ``step N loss
… acc …`` every ``--log-every`` steps, the final ``loss a -> b``) and the
launch counts of the port's kernels for the run. The reference prints the
final line only after more than 10 steps, comparing the means of the
first and last 5 losses; the port prints it from 2 steps on, over the
first and last ``min(5, steps // 2)`` (the same line past 10 steps).

``--mode ps`` runs the parameter-server runtime: any of the paper's nine
algorithms (``--algorithm all``, the default, runs them all; ``all-sync``
the sync pair) on the thread, process or tcp transport, each measured and
held against the DES calibrated once on the same device:

    PYTHONPATH=src python -m repro_torch.launch.train --mode ps \\
        --algorithm all --ps-workers 2 --ps-iters 80 --device cuda

    PYTHONPATH=src python -m repro_torch.launch.train --mode ps \\
        --algorithm async_easgd --transport process --ps-workers 2 \\
        --ps-iters 80 --device cpu

    PYTHONPATH=src python -m repro_torch.launch.train --mode ps \\
        --algorithm sync_easgd --model alexnet --ps-workers 4 \\
        --ps-iters 64 --bucket-bytes 4194304 --eta 0.005 --device cuda

    PYTHONPATH=src python -m repro_torch.launch.train --mode ps \\
        --algorithm sync_easgd --transport tcp --sync-plane p2p \\
        --schedule ring --ps-workers 4 --ps-iters 80 --trace --device cpu

    PYTHONPATH=src python -m repro_torch.launch.train --mode ps \\
        --algorithm sync_easgd --transport tcp --sync-plane p2p \\
        --schedule auto --ps-workers 4 --topology 2x2 --device cuda

``--topology HOSTSxSLOTS`` (sync family, thread or tcp) paces each
message on its link class of an emulated two-level fabric (cross-host
links ``--cross-alpha-x`` / ``--cross-beta-x`` times the intra-host PS
wire) in place of ``--emulate``; ``--schedule auto`` then chooses from a
link profile measured by the calibration. ``--model jax-mlp`` is the
reference's autograd MLP problem.

Each algorithm prints the reference's result line (``measured=…us/iter
des=…us/iter ratio=…``) with the run's device after the schedule and the
launch counts of every kernel of the port over the DES run and the
measured run together (the update kernels; with ``--model gemma3-4b``
also the attention and cross-entropy kernels, with ``--model
mamba2-780m`` the SSD and cross-entropy kernels).

With ``--trace`` it also writes the merged Chrome trace and prints the
Table-3 shares (``trace: comm=… compute=… update=…``). On tcp,
``--compression`` is the wire codec.

``--device`` defaults to ``cuda``; ``--device cpu`` runs the kernels'
plain versions on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

import numpy as np
import torch.distributed as dist

if __package__ in (None, ""):     # run as a file: put src on the path
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from repro_torch import configs, kernels  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.comm import schedules as comm_schedules  # noqa: E402
from repro_torch.core import compression, costmodel  # noqa: E402
from repro_torch.core.async_engine import ALGORITHMS  # noqa: E402
from repro_torch.core.easgd import EASGDConfig  # noqa: E402
from repro_torch.core.easgd_flat import SYNC_FAMILY  # noqa: E402
from repro_torch.core import elastic  # noqa: E402
from repro_torch.core.elastic import ElasticConfig  # noqa: E402
from repro_torch.data.pipeline import ShardedPipeline  # noqa: E402
from repro_torch.data.synthetic import SyntheticLMStream  # noqa: E402
from repro_torch.ft.watchdog import Watchdog  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.obs import report as obs_report  # noqa: E402
from repro_torch.ps import runtime, zoo  # noqa: E402
from repro_torch.runtime.train import build_train_step  # noqa: E402


def run_ps_mode(args) -> list:
    """--mode ps: run algorithms on the PS runtime and hold the measured
    clock against the DES calibrated once on the same device."""
    algos = {"all": list(ALGORITHMS),
             "all-sync": list(SYNC_FAMILY)}.get(args.algorithm,
                                                [args.algorithm])
    easgd = EASGDConfig(eta=args.eta, rho=args.rho, mu=0.9, tau=args.tau)
    wire_codec = args.compression if args.transport == "tcp" else "none"
    if wire_codec not in ("none", "sign_ef"):
        raise SystemExit(f"--mode ps --transport tcp supports wire "
                         f"compression none|sign_ef, got '{wire_codec}'")
    if args.sync_plane == "p2p" and args.transport != "tcp":
        raise SystemExit("--sync-plane p2p needs --transport tcp (the p2p "
                         "data plane is worker↔worker sockets)")
    problem = zoo.resolve(args.model)
    net = costmodel.PS_WIRE if args.emulate == "wire" else None
    topology = None
    if args.topology:
        try:
            hosts, slots = (int(x) for x in args.topology.lower().split("x"))
        except ValueError:
            raise SystemExit(f"--topology wants HOSTSxSLOTS (e.g. 2x8), "
                             f"got '{args.topology}'")
        if hosts * slots != args.ps_workers:
            raise SystemExit(f"--topology {hosts}x{slots} does not tile "
                             f"--ps-workers {args.ps_workers}")
        if args.transport not in ("thread", "tcp"):
            raise SystemExit("--topology needs --transport thread or tcp "
                             "(per-link pacing lives on those planes)")
        topology = costmodel.emulated_topology(
            hosts, slots, cross_alpha_x=args.cross_alpha_x,
            cross_beta_x=args.cross_beta_x)
        algos = [a for a in algos if a in SYNC_FAMILY]
        if not algos:
            raise SystemExit("--topology prices the sync-family exchange — "
                             "pick a sync_* algorithm (or 'all')")
        net = None      # the topology replaces the global emulated wire
    base = runtime.PSConfig(
        algorithm=algos[0], n_workers=args.ps_workers,
        transport=args.transport, schedule=args.schedule or "ring",
        total_iters=args.ps_iters, eval_every_iters=args.ps_eval_every,
        emulate_net=net, wire_compression=wire_codec,
        bucket_bytes=args.bucket_bytes, overlap=not args.no_overlap,
        topology=topology,
        trace=args.trace or bool(args.trace_dir), trace_dir=args.trace_dir)
    cal = runtime.calibrate(problem, base, device=args.device)
    out = []
    for algo in algos:
        # the p2p plane exists for the sync family only: `--algorithm all
        # --sync-plane p2p` runs the others through the master
        plane = args.sync_plane if algo in SYNC_FAMILY else "master"
        cfg = dataclasses.replace(base, algorithm=algo, sync_plane=plane)
        kernels.reset_launch_counts()
        res, _, rec = runtime.run_vs_des(problem, easgd, cfg, cal=cal,
                                         device=args.device)
        print(f"{algo:16s} [{res.transport}/{res.schedule}@{res.device}] "
              f"iters={res.total_iters} err={res.final_metric:.3f} "
              f"measured={rec['measured_us_per_iter']:.1f}us/iter "
              f"des={rec['des_us_per_iter']:.1f}us/iter "
              f"ratio={rec['measured_over_des']:.2f} "
              f"counters={res.counters} "
              f"launches={kernels.launch_counts()}", flush=True)
        if res.trace is not None:
            report_trace(res, algo, args.trace_dir)
        out.append(res)
    return out


def report_trace(res, algo: str, trace_dir) -> str:
    """Write the merged Chrome trace beside the run (open it at
    https://ui.perfetto.dev) and print the measured Table-3 shares."""
    rep = res.trace.get("report", {})
    path = str(Path(trace_dir or ".") / f"trace-{algo}-{res.transport}.json")
    obs_report.write_chrome_trace(path, res.trace)
    print(f"{algo:16s} trace: comm={rep.get('mean_comm_share', 0):.1%} "
          f"compute={rep.get('mean_compute_share', 0):.1%} "
          f"update={rep.get('mean_update_share', 0):.1%} -> {path}",
          flush=True)
    return path


def host_mesh_for(world: int, n_pods: int, device=None):
    """The launcher's mesh of ``world`` processes for ``n_pods`` pods."""
    if world % n_pods == 0:
        pod = n_pods
    elif n_pods % world == 0:
        pod = world
    else:
        raise ValueError(f"--n-pods {n_pods} and a world of {world}: one "
                         f"must divide the other")
    return mesh_lib.make_host_mesh(n_data=world // pod, n_model=1,
                                   n_pods=pod if n_pods > 1 else 0,
                                   device=device)


def run_sync_mode(args) -> list:
    """--mode sync: the packed multi-pod Sync EASGD step on the pipeline,
    with checkpoints and the watchdog, as the reference's sync mode."""
    owned = not dist.is_initialized()
    world = mesh_lib.init_world(args.device)
    try:
        return _run_sync(args, host_mesh_for(world, max(args.n_pods, 1),
                                             args.device))
    finally:
        if owned:
            dist.destroy_process_group()


def _run_sync(args, mesh) -> list:
    args.schedule = args.schedule or "psum"
    spec = configs.get(args.arch)
    cfg = spec.reduced if args.reduced else spec.config
    n_pods = max(args.n_pods, 1)
    world, rank = dist.get_world_size(), dist.get_rank()
    say = print if rank == 0 else (lambda *a, **k: None)
    ecfg = ElasticConfig(
        easgd=EASGDConfig(eta=args.eta, rho=args.rho, mu=0.9, tau=args.tau),
        schedule=args.schedule, overlap=not args.no_overlap,
        compression=args.compression, momentum_dtype=spec.momentum_dtype,
        center_dtype=spec.center_dtype)
    say(f"exchange: schedule={args.schedule} "
        f"compression={args.compression} "
        f"overlap={not args.no_overlap} n_pods={n_pods}", flush=True)
    if world > 1:
        say(f"mesh: {mesh_lib.axis_sizes(mesh)} over {world} processes",
            flush=True)
    per_pod = args.batch // n_pods
    build = build_train_step(cfg, ecfg, n_pods=n_pods, per_pod_batch=per_pod,
                             seq=args.seq, microbatches=args.microbatches,
                             device=args.device, mesh=mesh)
    state = build.init_state()

    def whole(st):
        return st if world == 1 else elastic.gather_state(
            st, mesh, build.param_specs)

    pipe = ShardedPipeline(
        lambda shard, n: SyntheticLMStream(cfg.vocab_size, args.seq, per_pod,
                                           seed=13, shard=shard, n_shards=n),
        n_pods=n_pods).start()

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start_step = 0
    if ckpt and ckpt.latest_step() is not None:
        state, meta = ckpt.restore(whole(state))
        if world > 1:
            state = elastic.shard_state(state, mesh, build.param_specs)
        start_step = meta["extra"]["data_step"]
        pipe.restore(start_step)
        say(f"resumed from step {start_step}")

    kernels.reset_launch_counts()
    wd = Watchdog().start_heartbeat()
    t0 = time.time()
    losses = []
    step = start_step
    try:
        for step in range(start_step, args.steps):
            if wd.should_stop.is_set():
                say("preemption signal — checkpoint + clean exit")
                break
            state, metrics = build.step(state, pipe.next())
            losses.append(float(metrics["loss"]))
            if step % args.log_every == 0:
                say(f"step {step:5d} loss {losses[-1]:.4f} "
                    f"acc {float(metrics['accuracy']):.3f} "
                    f"({time.time()-t0:.1f}s)", flush=True)
            if ckpt and step and step % args.ckpt_every == 0:
                full = whole(state)
                if rank == 0:
                    ckpt.save_async(step, full,
                                    extra={"data_step": step + 1})
    finally:
        pipe.stop()
        if ckpt:
            full = whole(state)
            if rank == 0:
                ckpt.wait()
                ckpt.save(step, full, extra={"data_step": step + 1})
        wd.close()
    if len(losses) >= 2:
        k = min(5, len(losses) // 2)
        first = np.mean(losses[:k])
        last = np.mean(losses[-k:])
        say(f"loss {first:.4f} -> {last:.4f} "
            f"({'improved' if last < first else 'NOT improved'})")
    say(f"launches={kernels.launch_counts()}", flush=True)
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="sync", choices=["sync", "ps"],
                    help="sync: the packed multi-pod Sync EASGD step "
                         "(default); ps: the parameter-server runtime")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; an error without a GPU) or cpu")
    ap.add_argument("--eta", type=float, default=0.02)
    ap.add_argument("--rho", type=float, default=0.01)
    ap.add_argument("--tau", type=int, default=1)
    ap.add_argument("--schedule", default=None,
                    choices=list(comm_schedules.names()) + ["auto"],
                    help="cross-pod exchange schedule ('auto' picks via "
                         "comm.choose). Default: psum in sync mode, ring in "
                         "ps mode")
    # --mode sync options
    ap.add_argument("--arch", default="gemma3-4b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8,
                    help="global batch (sequences)")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--n-pods", type=int, default=1)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compression", default="none",
                    choices=sorted(compression.SCHEMES),
                    help="exchange compression; with --mode ps --transport "
                         "tcp the wire codec (none or sign_ef)")
    ap.add_argument("--no-overlap", action="store_true",
                    help="run the exchange after the gradients (Sync "
                         "EASGD1/2 baseline, paper §6.1.3); in ps mode the "
                         "p2p plane's no-overlap baseline")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--log-every", type=int, default=5)
    # --mode ps options
    ap.add_argument("--algorithm", default="all",
                    choices=list(ALGORITHMS) + ["all", "all-sync"])
    ap.add_argument("--transport", default="thread",
                    choices=["thread", "process", "tcp"],
                    help="process and tcp workers need a numpy or zoo "
                         "--model (they rebuild it from its ProblemSpec); "
                         "tcp workers are localhost processes on "
                         "--device behind real sockets")
    ap.add_argument("--sync-plane", default="master",
                    choices=["master", "p2p"],
                    help="tcp sync family: 'p2p' executes the schedule's "
                         "rounds over worker↔worker links (the master only "
                         "coordinates)")
    ap.add_argument("--trace", action="store_true",
                    help="record spans on every worker (and the master), "
                         "write trace-<algo>-<transport>.json (Perfetto) "
                         "and print the measured Table-3 shares")
    ap.add_argument("--trace-dir", default=None,
                    help="directory for worker trace spills and the merged "
                         "trace (implies --trace)")
    ap.add_argument("--model", default="tiny-mlp",
                    help="tiny-mlp (default), mlp, mlp-large, jax-mlp (the "
                         "autograd MLP), lenet, alexnet, gemma3-4b or "
                         "mamba2-780m (the reduced LMs)")
    ap.add_argument("--ps-workers", type=int, default=4)
    ap.add_argument("--ps-iters", type=int, default=400)
    ap.add_argument("--ps-eval-every", type=int, default=200)
    ap.add_argument("--bucket-bytes", type=int, default=0,
                    help="bucket the exchange into ~this many payload bytes "
                         "per bucket, cut at layer edges (0 = monolithic)")
    ap.add_argument("--emulate", default="wire", choices=["wire", "none"],
                    help="'wire' sleeps each master message / exchange "
                         "round's α+nβ under costmodel.PS_WIRE; 'none' uses "
                         "raw device memory")
    ap.add_argument("--topology", default=None, metavar="HOSTSxSLOTS",
                    help="ps sync family: emulate a two-level fabric (e.g. "
                         "2x8; HOSTSxSLOTS must equal --ps-workers): "
                         "cross-host links pace at --cross-alpha-x / "
                         "--cross-beta-x times the intra-host PS wire and "
                         "'--schedule auto' chooses per link class. "
                         "Replaces --emulate")
    ap.add_argument("--cross-alpha-x", type=float, default=20.0,
                    help="cross-host latency multiplier for --topology "
                         "(default 20)")
    ap.add_argument("--cross-beta-x", type=float, default=4.0,
                    help="cross-host inverse-bandwidth multiplier for "
                         "--topology (default 4)")
    args = ap.parse_args(argv)
    if args.mode == "ps":
        return run_ps_mode(args)
    return run_sync_mode(args)


if __name__ == "__main__":
    main()

"""Training entry point of the port: ``--mode ps`` runs the Sync EASGD /
Sync SGD parameter-server runtime on the thread transport (the port of
``repro/launch/train.py --mode ps``).

    PYTHONPATH=src python -m repro_torch.launch.train --mode ps \\
        --algorithm sync_easgd --transport thread --model alexnet \\
        --ps-workers 4 --ps-iters 64 --bucket-bytes 4194304 --device cuda

    PYTHONPATH=src python -m repro_torch.launch.train --mode ps \\
        --model gemma3-4b --ps-workers 2 --ps-iters 8 --device cpu

Each algorithm prints the reference's result line without the DES columns
(the DES cross-check is not ported yet), plus the launch counts of every
kernel of the port for the run (the update kernels; with ``--model
gemma3-4b`` also the attention and cross-entropy kernels). ``--device``
defaults to ``cuda``; ``--device cpu`` runs the kernels' plain versions on
the CPU.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

if __package__ in (None, ""):     # run as a file: put src on the path
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from repro_torch.comm import schedules as comm_schedules  # noqa: E402
from repro_torch.core import costmodel  # noqa: E402
from repro_torch.core.easgd import EASGDConfig  # noqa: E402
from repro_torch.core.easgd_flat import SYNC_FAMILY  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.ps import runtime, zoo  # noqa: E402


def run_ps_mode(args) -> list:
    algos = (list(SYNC_FAMILY) if args.algorithm == "all-sync"
             else [args.algorithm])
    easgd = EASGDConfig(eta=args.eta, rho=args.rho, mu=0.9, tau=args.tau)
    problem = zoo.resolve(args.model)
    out = []
    for algo in algos:
        cfg = runtime.PSConfig(
            algorithm=algo, n_workers=args.ps_workers,
            transport=args.transport, schedule=args.schedule,
            total_iters=args.ps_iters, eval_every_iters=args.ps_eval_every,
            emulate_net=costmodel.PS_WIRE if args.emulate == "wire" else None,
            bucket_bytes=args.bucket_bytes)
        kernels.reset_launch_counts()
        res = runtime.run_ps(problem, easgd, cfg, device=args.device)
        us = 1e6 * res.total_time_s / max(res.total_iters, 1)
        print(f"{algo:16s} [{res.transport}/{res.schedule}@{res.device}] "
              f"iters={res.total_iters} err={res.final_metric:.3f} "
              f"measured={us:.1f}us/iter counters={res.counters} "
              f"launches={kernels.launch_counts()}", flush=True)
        out.append(res)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="ps", choices=["ps"],
                    help="ps: the parameter-server runtime (the multi-pod "
                         "sync mode is not ported yet)")
    ap.add_argument("--algorithm", default="all-sync",
                    choices=list(SYNC_FAMILY) + ["all-sync"])
    ap.add_argument("--transport", default="thread", choices=["thread"])
    ap.add_argument("--model", default="tiny-mlp",
                    help="tiny-mlp (default), mlp, lenet, alexnet or "
                         "gemma3-4b (the reduced decoder LM)")
    ap.add_argument("--ps-workers", type=int, default=4)
    ap.add_argument("--ps-iters", type=int, default=400)
    ap.add_argument("--ps-eval-every", type=int, default=200)
    ap.add_argument("--schedule", default="ring",
                    choices=list(comm_schedules.names()) + ["auto"])
    ap.add_argument("--bucket-bytes", type=int, default=0,
                    help="bucket the exchange into ~this many payload bytes "
                         "per bucket, cut at layer edges (0 = monolithic)")
    ap.add_argument("--emulate", default="wire", choices=["wire", "none"],
                    help="'wire' sleeps each exchange round's α+nβ under "
                         "costmodel.PS_WIRE; 'none' uses raw device memory")
    ap.add_argument("--eta", type=float, default=0.02)
    ap.add_argument("--rho", type=float, default=0.01)
    ap.add_argument("--tau", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; an error without a GPU) or cpu")
    args = ap.parse_args(argv)
    return run_ps_mode(args)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the script (non-zero exit) if it fails:

1. build every CUDA source of the port with ``nvcc`` for sm_90a;
2. hold each kernel against its plain PyTorch version on the card, bitwise,
   at n ∈ {1188, 131072+777, 6,976,842}, and time both at AlexNet's row
   length with CUDA events (median of 30 launches) beside the memory bound;
3. run the port's Sync EASGD and Sync SGD on the numpy MLP on the card and
   on the CPU and require the same bits (the CPU run is itself pinned bit
   for bit to the reference ``repro.ps`` by tests/test_torch_ps.py);
4. hold the card's AlexNet and LeNet gradients against the CPU's
   (TF32 off, relative norm ≤ 1e-5);
5. the main path: ``run_ps`` on full-width AlexNet (6,976,842 parameters),
   P = 4 workers, ring, 4 MiB buckets, Sync EASGD and then Sync SGD, with
   the kernels' launch counters set to 0 just before each run and read just
   after; each kernel must have launched in its run.

The last three lines are the card's name and power limit as ``nvidia-smi``
gives them, a JSON ``kernels`` line, and the JSON result line
``{"ok": true, "device": {...}}``. Without a GPU, or without the port's
sources beside this file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"

# data-sheet peaks per card (memory bytes/s, f64 operations/s outside the
# tensor cores), matched on the name nvidia-smi reports; first match wins
PEAKS = (("H100 PCIe", 2.0e12, 25.6e12), ("H100 NVL", 3.9e12, 30e12),
         ("H200", 4.8e12, 34e12), ("H100", 3.35e12, 34e12))

ETA, RHO, MU = 0.05, 0.07, 0.9
N_ALEXNET = 6_976_842
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/elastic_update.cu"


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def peaks_for(name: str) -> tuple:
    for key, bw, f64 in PEAKS:
        if key in name:
            return bw, f64
    raise RuntimeError(f"no data-sheet peaks for card '{name}'")


def bound(n_bytes: float, n_ops: float, bw: float, f64: float) -> tuple:
    t_bytes, t_ops = n_bytes / bw, n_ops / f64
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def phase_kernels(torch, eu, timing, dev, bw, f64) -> dict:
    """Each kernel against its plain version, bitwise; timings at n_alexnet."""
    gen = torch.Generator(device=dev).manual_seed(11)

    def rows(n, k):
        return [torch.randn(n, generator=gen, device=dev,
                            dtype=torch.float64) for _ in range(k)]

    err = {"easgd": 0.0, "sgd": 0.0}
    for n in (1188, 131072 + 777, N_ALEXNET):
        for p in (3, 4):
            w, g, c, r = rows(n, 4)
            r *= p
            w_k, c_k = w.clone(), torch.empty_like(c)
            eu.fused_sync_easgd_update(w_k, g, c, r, p, ETA, RHO,
                                       center_out=c_k)
            w_p, c_p = w.clone(), torch.empty_like(c)
            eu.fused_sync_easgd_update_ref(w_p, g, c, r, p, ETA, RHO,
                                           center_out=c_p)
            w_solo = w.clone()
            eu.fused_sync_easgd_update(w_solo, g, c, r, p, ETA, RHO)
            torch.cuda.synchronize()
            check(torch.equal(w_k, w_p) and torch.equal(c_k, c_p)
                  and torch.equal(w_solo, w_k), f"easgd kernel == plain, "
                  f"n={n} P={p}")
            err["easgd"] = max(err["easgd"], (w_k - w_p).abs().max().item(),
                               (c_k - c_p).abs().max().item())
            v = rows(n, 1)[0]
            c_k, v_k, c_p, v_p = c.clone(), v.clone(), c.clone(), v.clone()
            eu.fused_sync_sgd_update(c_k, v_k, r, p, ETA, MU)
            eu.fused_sync_sgd_update_ref(c_p, v_p, r, p, ETA, MU)
            torch.cuda.synchronize()
            check(torch.equal(c_k, c_p) and torch.equal(v_k, v_p),
                  f"sgd kernel == plain, n={n} P={p}")
            err["sgd"] = max(err["sgd"], (c_k - c_p).abs().max().item(),
                             (v_k - v_p).abs().max().item())
        print(f"kernels == plain versions at n={n} (P=3, 4): bitwise",
              flush=True)

    n, p = N_ALEXNET, 4
    w, g, c, r, c_out, v = rows(n, 6)
    t = {
        "easgd": timing.cuda_time_ms(
            lambda: eu.fused_sync_easgd_update(w, g, c, r, p, ETA, RHO,
                                               center_out=c_out), reps=30),
        "easgd_plain": timing.cuda_time_ms(
            lambda: eu.fused_sync_easgd_update_ref(w, g, c, r, p, ETA, RHO,
                                                   center_out=c_out),
            reps=30),
        "easgd_solo": timing.cuda_time_ms(
            lambda: eu.fused_sync_easgd_update(w, g, c, r, p, ETA, RHO),
            reps=30),
        "sgd": timing.cuda_time_ms(
            lambda: eu.fused_sync_sgd_update(c, v, r, p, ETA, MU), reps=30),
        "sgd_plain": timing.cuda_time_ms(
            lambda: eu.fused_sync_sgd_update_ref(c, v, r, p, ETA, MU),
            reps=30),
    }
    # bytes: each input read once, each output written once; operations:
    # easgd 5 for W' + 4 for C' per element, sgd 5 per element
    b_easgd, by_easgd = bound(6 * 8 * n, 9 * n, bw, f64)
    b_solo, _ = bound(4 * 8 * n, 5 * n, bw, f64)
    b_sgd, by_sgd = bound(5 * 8 * n, 5 * n, bw, f64)
    print(f"fused_sync_easgd_update n={n}: kernel {t['easgd']:.4f} ms, "
          f"plain {t['easgd_plain']:.4f} ms, bound {b_easgd:.4f} ms "
          f"({by_easgd}); without center {t['easgd_solo']:.4f} ms, bound "
          f"{b_solo:.4f} ms", flush=True)
    print(f"fused_sync_sgd_update   n={n}: kernel {t['sgd']:.4f} ms, "
          f"plain {t['sgd_plain']:.4f} ms, bound {b_sgd:.4f} ms ({by_sgd})",
          flush=True)
    return {
        "fused_sync_easgd_update": {
            "replaces": "src/repro/kernels/elastic_update.py:119",
            "max_abs_err": err["easgd"], "ms": t["easgd"],
            "plain_ms": t["easgd_plain"], "bound_ms": b_easgd,
            "bound_by": by_easgd, "ms_without_center": t["easgd_solo"],
            "bound_ms_without_center": b_solo},
        "fused_sync_sgd_update": {
            "replaces": "src/repro/kernels/elastic_update.py:148",
            "max_abs_err": err["sgd"], "ms": t["sgd"],
            "plain_ms": t["sgd_plain"], "bound_ms": b_sgd,
            "bound_by": by_sgd},
    }


def phase_card_vs_cpu(torch, runtime, problems, EASGDConfig) -> None:
    """The numpy MLP run on the card equals the CPU run, bit for bit."""
    easgd = EASGDConfig(eta=ETA, rho=RHO, mu=MU)
    for algo in ("sync_easgd", "sync_sgd"):
        for p in (3, 4):
            cfg = runtime.PSConfig(algorithm=algo, n_workers=p,
                                   total_iters=36, schedule="ring",
                                   eval_every_iters=10**9, bucket_bytes=256)
            gpu = runtime.run_ps(problems.NUMPY_MLP, easgd, cfg,
                                 device="cuda")
            cpu = runtime.run_ps(problems.NUMPY_MLP, easgd, cfg, device="cpu")
            check(torch.equal(gpu.center.cpu(), cpu.center)
                  and torch.equal(gpu.workers.cpu(), cpu.workers)
                  and gpu.counters == cpu.counters,
                  f"{algo} P={p} numpy MLP: card == CPU")
            print(f"{algo} numpy MLP ring P={p}: card == CPU, bitwise "
                  f"(center, workers, counters)", flush=True)


def phase_gradients(torch, zoo, timing) -> None:
    """AlexNet / LeNet gradients on the card against the CPU's, and the
    time of one gradient on the card (cuDNN off, as the zoo runs it, and
    on, for comparison)."""
    for model in ("alexnet", "lenet"):
        w0, _, _ = zoo.make_zoo_cnn(model, device="cpu")
        _, g_cpu_fn, _ = zoo.make_zoo_cnn(model, w0=w0, device="cpu")
        w_gpu, g_gpu_fn, _ = zoo.make_zoo_cnn(model, w0=w0, device="cuda")
        g_cpu = g_cpu_fn(w0, 0, 0)
        g_gpu = g_gpu_fn(w_gpu, 0, 0).cpu()
        rel = (torch.linalg.vector_norm(g_gpu - g_cpu)
               / torch.linalg.vector_norm(g_cpu)).item()
        check(rel <= 1e-5, f"{model} gradient card vs CPU rel {rel:.3e}")
        ms = {}
        for cudnn in (False, True):
            torch.backends.cudnn.enabled = cudnn
            g_gpu_fn(w_gpu, 0, -9)                       # warm-up
            with timing.Timer("cuda") as tm:
                for k in range(10):
                    g_gpu_fn(w_gpu, k, -9)
            ms[cudnn] = 1e3 * tm.elapsed / 10
        # what the zoo avoids by turning cuDNN off: reported, not held
        _, g_cudnn_fn, _ = zoo.make_zoo_cnn(model, w0=w0, device="cuda")
        torch.backends.cudnn.enabled = True
        g_cudnn = g_cudnn_fn(w_gpu, 0, 0).cpu()
        torch.backends.cudnn.enabled = False
        rel_cudnn = (torch.linalg.vector_norm(g_cudnn - g_cpu)
                     / torch.linalg.vector_norm(g_cpu)).item()
        print(f"{model} gradient (n={w0.numel()}): card vs CPU relative "
              f"norm {rel:.3e} (limit 1e-5; {rel_cudnn:.3e} through "
              f"cuDNN); {ms[False]:.2f} ms per gradient on the card "
              f"({ms[True]:.2f} ms through cuDNN)", flush=True)


def phase_main_path(torch, runtime, zoo, eu, EASGDConfig) -> dict:
    """Full-width AlexNet, P = 4, ring, 4 MiB buckets; counters 0 before
    each run and read just after."""
    p, rounds = 4, 16
    # η = 0.01 already diverges on this AlexNet within 64 iterations, on
    # the port and on the reference alike; 0.005 stays finite
    easgd = EASGDConfig(eta=0.005, rho=0.01, mu=MU)
    problem = zoo.resolve("alexnet")
    launches = {}
    # the update runs over the whole row once per round: every worker's
    # easgd launch (rank 0's also writes the center), one sgd launch
    for algo, kernel, expected in (
            ("sync_easgd", eu.fused_sync_easgd_update, p * rounds),
            ("sync_sgd", eu.fused_sync_sgd_update, rounds)):
        cfg = runtime.PSConfig(algorithm=algo, n_workers=p,
                               total_iters=p * rounds, schedule="ring",
                               eval_every_iters=10**9, bucket_bytes=4 << 20)
        eu.reset_launch_counts()
        res = runtime.run_ps(problem, easgd, cfg, device="cuda")
        counts = eu.launch_counts()
        launches[kernel.__name__] = counts[kernel.__name__]
        check(res.center.numel() == N_ALEXNET and res.workers.shape
              == (p, N_ALEXNET), f"{algo} result shapes")
        check(bool(torch.isfinite(res.center).all())
              and bool(torch.isfinite(res.workers).all())
              and math.isfinite(res.final_metric), f"{algo} finite result")
        check(counts[kernel.__name__] == expected, f"{algo} launched "
              f"{kernel.__name__} {counts[kernel.__name__]} times, expected "
              f"{expected}")
        us = 1e6 * res.total_time_s / res.total_iters
        print(f"main path {algo} alexnet n={res.center.numel()} P={p} "
              f"ring bucket=4MiB: {res.total_iters} iters in "
              f"{res.total_time_s:.3f} s = {us:.1f} us/iter, final err "
              f"{res.final_metric:.4f}, counters {res.counters}, launches "
              f"{counts}", flush=True)
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found — run from a "
              f"checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.core.easgd import EASGDConfig
    from repro_torch.kernels import _build
    from repro_torch.kernels import elastic_update as eu
    from repro_torch.ps import problems, runtime, zoo
    from repro_torch.utils import timing

    card = card_line()
    name = torch.cuda.get_device_name(0)
    bw, f64 = peaks_for(card)
    print(f"card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | peaks {bw / 1e12:g} TB/s, f64 "
          f"{f64 / 1e12:g} TFLOP/s", flush=True)
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(built)}",
          flush=True)
    for src, log in built.items():
        for line in log.splitlines():
            print(f"  nvcc[{src}] {line}")

    t = time.perf_counter()
    rows = phase_kernels(torch, eu, timing, dev, bw, f64)
    print(f"phase kernels: {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    phase_card_vs_cpu(torch, runtime, problems, EASGDConfig)
    print(f"phase card vs CPU: {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    phase_gradients(torch, zoo, timing)
    print(f"phase gradients: {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    launches = phase_main_path(torch, runtime, zoo, eu, EASGDConfig)
    print(f"phase main path: {time.perf_counter() - t:.1f} s", flush=True)

    check("jax" not in sys.modules and not any(
        m == "repro" or m.startswith("repro.") for m in sys.modules),
        "no jax and no reference module imported")
    kernels = [dict(name=k, route="cuda", source=KERNEL_SOURCE,
                    replaces=row["replaces"], launches=launches[k],
                    max_abs_err=row["max_abs_err"], ms=row["ms"],
                    plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                    bound_by=row["bound_by"], library_ms=None, equal=True,
                    **{x: row[x] for x in row if x.endswith("without_center")})
               for k, row in rows.items()]
    print(f"total: {time.perf_counter() - t0:.1f} s", flush=True)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
5. the first main path: ``run_ps`` on full-width AlexNet (6,976,842
   parameters), P = 4 workers, ring, 4 MiB buckets, Sync EASGD and then
   Sync SGD, with the kernels' launch counters set to 0 just before each
   run and read just after; each counter must read exactly what the run
   implies (its update kernel once per worker or once per round, the
   others 0);
6. hold the attention and cross-entropy kernels (forward and backward)
   against their plain versions on the card, each output by its relative
   norm (the cross-entropy gradients also by their softmax part alone), at
   gemma3-4b's full width (attention B 1, S 4096, H 8, KVH 4, D 256, bf16,
   window 1024 and 0; cross-entropy T 4096, d 2560, V 262144, bf16), at the
   reduced shapes of phase 8, at bf16 head dims 32 and 128 and a ragged
   unmasked bf16 shape, and at small ragged f32 shapes; require two
   full-width attention backward calls, and two cross-entropy backward
   calls, to give the same bits; and time kernel, plain version and the
   library call with CUDA events beside the bound (for cross-entropy the
   two-call ``F.cross_entropy(h @ W, y)`` and its autograd backward). The
   build's ptxas output gives one line per attention and cross-entropy
   kernel instantiation: its instructions (wgmma, mma.sync or CUDA-core
   FMA), registers and spill bytes; a bf16 cross-entropy kernel that
   spills, or whose SASS (cuobjdump) holds no wgmma, fails the build;
7. gemma3-4b at full width, depth cut to 6 layers (1,237,356,032
   parameters, f32 params, bf16 compute), B 1, S 4096: ``lm_loss`` and its
   gradient through the kernels and through the plain versions, held to a
   relative 1e-3 (loss) and 2e-2 (gradient norm), with exact launch counts
   per gradient, each path's time the median of three gradients;
8. the second main path: ``run_ps`` on ``--model gemma3-4b`` (the reduced
   decoder, as the reference's PS trainer runs it), P = 4, ring, 64 KiB
   buckets, 16 rounds, Sync EASGD and then Sync SGD, counters 0 before each
   run and read after: every kernel must have launched exactly as often as
   the warm-up, the rounds and the evals imply;
9. hold ``fused_elastic_update`` against its plain version on the card, bit
   for bit, at n ∈ {1188, 131072+777, 6,976,842} × P ∈ {1, 2, 4} over the
   storage dtypes (all f32; params f32 with momentum and center bf16; all
   bf16), and time both at P = 2, f32, n = 2^28 (CUDA events, median of
   10) beside the bytes bound;
10. the third main path at full width: the packed multi-pod Sync EASGD step
   (``runtime.train.build_train_step``) on gemma3-4b cut to 6 layers, P = 2
   pods, B 1 per pod, S 4096, psum, overlap on, 3 steps, counters 0 before
   each step and read after (the update kernel once, attention 6·P and
   cross-entropy P times each way); the first step's update is held bit for
   bit against the plain version on a 2^20-element slice of its own
   inputs; it prints ms per step, the update kernel's time in the step
   beside its bound, the exchange's time and peak memory;
11. the launcher's path at reduced width: gemma3-4b reduced, P = 4, B 2 per
   pod in 2 microbatches, τ = 2, ring, 4 steps, compression none and bf16:
   overlap on and off give the same bits, the card's state equals a CPU
   run's (loss 1e-3 relative, params by relative norm 2e-2) and the update
   launches once per exchange step; then ``repro_torch.launch.train`` with
   the same settings on the card, with the same exact counts;
12. hold the SSD intra-chunk kernels (forward and backward) against their
   plain versions on the card, each output by its relative norm (y 1e-5;
   dx, db, dc, da 1e-4), at mamba2-780m's full width (B 1, S 4096, H 48,
   P 64, N 128, L 256, f32), at phase 15's reduced shapes (B 2, S 32, H 8,
   P 16, N 16, L 16) and on a chunk whose cumulative decay falls far below
   -88, two backward calls giving the same bits; time kernel and plain
   version at full width beside the bound (the bytes, or 3x the products
   at the dense TF32 rate: the kernels' 3xTF32 route) and the CUDA-core
   f32 bound, and by kernel (torch.profiler). The build's ptxas output and
   SASS give one line per SSD kernel: registers, spill bytes and its
   tensor-core products (HMMA); a kernel without any fails the build.
   Then the cross-entropy kernels at mamba2-780m's loss head (T 4096, d
   1536, V 50280, bf16) as phase 6 holds them;
13. mamba2-780m at full width and full depth (48 layers, 780,148,992
   parameters, f32 params, bf16 compute), B 1, S 4096: ``lm_loss`` and its
   gradient through the kernels and through the plain versions, with exact
   launch counts per gradient (SSD 48 each way, CE 1 each way, attention
   0), time and peak memory; the loss held to 1e-3. At 48 bf16 layers two
   exact evaluations of the gradient differ by far more than 2e-2 (the
   plain path against itself with the SSD plain versions run in f64 is
   printed beside the kernels' reading), so the gradient is held to 2e-2
   (and the loss to 1e-3) at f32 compute, at the same width and depth;
14. the fourth main path at full width: the multi-pod step of phase 10 on
   mamba2-780m at all 48 layers (P = 2, B 1 per pod, S 4096, psum,
   overlap on, 3 steps), counters 0 before each step and read after (the
   update once, SSD 48·P and CE P times each way);
15. the launcher's path at reduced width on mamba2-780m: phase 11 with
   compression none, then ``launch.train --arch mamba2-780m --reduced``,
   then ``run_ps`` on ``--model mamba2-780m`` (P = 4, ring, 16 rounds,
   Sync EASGD), each with exact launch counts;
16. the asynchronous slice on the PS trainer: (a) on the numpy MLP under
   deterministic admission, async_sgd / async_easgd / async_msgd /
   async_measgd / hogwild_easgd / original_easgd at P ∈ {3, 4}, the card's
   center, workers and counters equal the CPU's bit for bit, and the DES
   on the card (round_robin, no jitter) equals the card's real run;
   (b) full-width AlexNet, P = 4, 64 iterations, the seven non-sync
   disciplines in their real FCFS / lock-free / turnstile forms, each
   finite with its iteration count, 2 messages an exchange and the bytes
   to match, and its µs/iter; ``run_vs_des`` for async_easgd and
   hogwild_easgd (``measured_over_des``); (c) ``--model gemma3-4b`` with
   original_easgd and hogwild_easgd and ``--model mamba2-780m`` with
   deterministic async_measgd, exact launch counts; (d) the process
   transport (spawned workers, CUDA IPC): deterministic async_easgd and
   sync_easgd at P = 2 equal their thread runs bit for bit, with the update
   kernel's launches counted across processes, and one FCFS async_easgd
   run on AlexNet; (e) ``launch.train --mode ps --algorithm all`` on
   tiny-mlp: nine lines with finite errors and the DES columns;
17. the tcp slice (worker processes on the card behind real sockets):
   (a) on the numpy MLP under deterministic admission, sync_easgd at
   P ∈ {2, 3}, sync_sgd at 4 and async_easgd at 2, the card's tcp run ==
   the card's thread run == the CPU's thread run bit for bit, and the
   thread ↔ tcp master ↔ tcp p2p triangle (sync_easgd tree 2 and ring 3,
   sync_sgd butterfly 4) on the card, with the update kernels' launches
   counted exactly in the master or in the workers (BYE); (b) full-width
   AlexNet, P = 4, ring, 4 MiB buckets, 16 rounds, Sync EASGD on the
   thread plane, the tcp master plane and the tcp p2p plane with overlap
   on, off and with sign_ef: µs/iter untraced and traced, the Table-3
   shares, master / peer / wire bytes, exact update launches, the loopback
   α–β, and whether each tcp run equals the thread run bit for bit
   (reported); (c) tracing's cost on the thread plane (AlexNet, traced
   and untraced in turns); (d) ``launch.train --transport tcp
   --sync-plane p2p --trace`` and ``launch.cluster`` as subprocesses;
   (e) reduced gemma3-4b over tcp p2p, P = 2, 16 rounds, attention and
   cross-entropy launched in the workers and counted exactly;
18. the live telemetry plane and elastic membership over tcp: (a) on the
   numpy MLP under deterministic admission, a chaos dial-refuse window
   (sync_easgd, P = 2) and one link paced 3x slower (``link_slow``,
   async_easgd, P = 3): the card's tcp run == the card's thread run == the
   CPU's thread run bit for bit; (b) full-width AlexNet, P = 4, ring, p2p,
   4 MiB buckets, 16 rounds, Sync EASGD with telemetry off and on (µs/iter
   of each beside phase 17b's), and a P = 3 hogwild_easgd run with wid 2's
   link paced 8x slower, whose straggler the detector must name while
   ``launch.monitor --connect --follow`` reads STATS snapshots mid-run;
   (c) the same AlexNet cell with ``elastic=True``, wid 2 SIGKILLed at
   iteration 8 and respawned on the reconfigure event: epoch 2 with all
   four members, the time to recover, the rejoin time with the
   rejoiner's import and card time, µs/iter per epoch, the update's
   launches exact against the workers' epoch logs (P = 4, 3, 4), one
   post-shrink bucket update at P = 3 bitwise its plain version; then on
   the numpy MLP a SIGTERM departure, a p2p sync_sgd kill and respawn,
   master-plane sync_easgd and sync_sgd kills (the plan rebuilt for
   P′ = 2) and a kill with elastic off, which must fail.

The last three lines are the card's name and power limit as ``nvidia-smi``
gives them, a JSON ``kernels`` line, and the JSON result line
``{"ok": true, "device": {...}}``. Without a GPU, or without the port's
sources beside this file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"

# data-sheet peaks per card (memory bytes/s, f64 operations/s outside the
# tensor cores, dense bf16 tensor-core operations/s, f32 operations/s
# outside the tensor cores, dense TF32 tensor-core operations/s: half the
# bf16 rate on Hopper), matched on the name nvidia-smi reports; first match
# wins
PEAKS = (("H100 PCIe", 2.0e12, 25.6e12, 756e12, 51.2e12, 378e12),
         ("H100 NVL", 3.9e12, 30e12, 835e12, 60e12, 417.5e12),
         ("H200", 4.8e12, 34e12, 989e12, 67e12, 494.5e12),
         ("H100", 3.35e12, 34e12, 989e12, 67e12, 494.5e12))

ETA, RHO, MU = 0.05, 0.07, 0.9
N_ALEXNET = 6_976_842
N_GEMMA_6L = 1_237_356_032
N_MAMBA2 = 780_148_992
CSRC = "src/repro_torch/kernels/csrc/"
KERNEL_SOURCE = CSRC + "elastic_update.cu"
# limits on the relative norm ||kernel - plain|| / ||plain|| of one output.
# f32 outputs take the f32 tolerances of tests/test_kernels.py whatever the
# inputs' dtype: lse and the cross-entropy loss are f32 sums of the same
# exact products in kernel and plain version. bf16 outputs take LIMIT_BF16,
# set from the card's readings (PERF.md).
LIMIT_F32 = {"fwd": 1e-5, "bwd": 1e-4}
LIMIT_BF16 = 1e-2


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
    for key, *peaks in PEAKS:
        if key in name:
            return tuple(peaks)
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


def phase_main_path(torch, runtime, zoo, kernels, EASGDConfig) -> dict:
    """Full-width AlexNet, P = 4, ring, 4 MiB buckets; counters 0 before
    each run and read just after."""
    p, rounds = 4, 16
    totals = {k.__name__: 0 for k in kernels.KERNELS}
    # η = 0.01 already diverges on this AlexNet within 64 iterations, on
    # the port and on the reference alike; 0.005 stays finite
    easgd = EASGDConfig(eta=0.005, rho=0.01, mu=MU)
    problem = zoo.resolve("alexnet")
    # the update runs over the whole row once per round: every worker's
    # easgd launch (rank 0's also writes the center), one sgd launch; the
    # CNN launches no other kernel of the port
    for algo, update, n_update in (
            ("sync_easgd", "fused_sync_easgd_update", p * rounds),
            ("sync_sgd", "fused_sync_sgd_update", rounds)):
        cfg = runtime.PSConfig(algorithm=algo, n_workers=p,
                               total_iters=p * rounds, schedule="ring",
                               eval_every_iters=10**9, bucket_bytes=4 << 20)
        kernels.reset_launch_counts()
        res = runtime.run_ps(problem, easgd, cfg, device="cuda")
        counts = kernels.launch_counts()
        check(res.center.numel() == N_ALEXNET and res.workers.shape
              == (p, N_ALEXNET), f"{algo} result shapes")
        check(bool(torch.isfinite(res.center).all())
              and bool(torch.isfinite(res.workers).all())
              and math.isfinite(res.final_metric), f"{algo} finite result")
        expected = {k: 0 for k in counts}
        expected[update] = n_update
        check(counts == expected, f"{algo} on alexnet launched {counts}, "
              f"expected {expected}")
        for k, v in counts.items():
            totals[k] += v
        us = 1e6 * res.total_time_s / res.total_iters
        print(f"main path {algo} alexnet n={res.center.numel()} P={p} "
              f"ring bucket=4MiB: {res.total_iters} iters in "
              f"{res.total_time_s:.3f} s = {us:.1f} us/iter, final err "
              f"{res.final_metric:.4f}, counters {res.counters}, launches "
              f"{counts}", flush=True)
    return totals


# ---------------------------------------------------------------------------
# the gemma3-4b slice: attention and cross-entropy kernels
# ---------------------------------------------------------------------------

def rel_norm(got, want, scale=None) -> float:
    """||got - want|| / ||scale||, the scale being ``want`` unless given."""
    den = want.float() if scale is None else scale.float()
    return ((got.float() - want.float()).norm() / den.norm()).item()


def hold(row: dict, what: str, kind: str, outs) -> None:
    """Hold each output ``(label, got, plain[, scale])`` by its relative
    norm against its limit. The kernel's row keeps the largest |error| and
    the reading nearest its limit, with that limit."""
    for label, got, want, *scale in outs:
        limit = LIMIT_F32[kind] if got.element_size() == 4 else LIMIT_BF16
        rel = rel_norm(got, want, *scale)
        abs_err = (got.float() - want.float()).abs().max().item()
        check(rel <= limit, f"{what} {label}: relative norm {rel:.3e} > "
              f"limit {limit:g}")
        row["max_abs_err"] = max(row.get("max_abs_err", 0.0), abs_err)
        if rel / limit >= row.get("err_to_tol", 0.0):
            row.update(rel_err=rel, tol=limit, err_to_tol=rel / limit)
        print(f"{what} {label}: kernel vs plain relative norm {rel:.3e} "
              f"(limit {limit:g}), max |err| {abs_err:.3e}", flush=True)


def attn_pairs(S: int, causal: bool, window: int) -> int:
    """(query, key) pairs the masks leave in one head: the work this run's
    masks need, not the S² a dense product would do."""
    total = 0
    for q in range(S):
        lo = max(0, q - window + 1) if window else 0
        hi = q + 1 if causal else S
        total += max(0, hi - lo)
    return total


# B, S, H, KVH, D, causal, window, dtype, timed: gemma3-4b's local and
# global layers at full width and at phase 8's reduced shapes, and small
# ragged f32 shapes
ATTN_CASES = ((1, 4096, 8, 4, 256, True, 1024, "bfloat16", True),
              (1, 4096, 8, 4, 256, True, 0, "bfloat16", True),
              (2, 24, 4, 2, 16, True, 8, "bfloat16", False),
              (2, 24, 4, 2, 16, True, 0, "bfloat16", False),
              (1, 100, 4, 2, 32, True, 0, "bfloat16", False),
              (2, 150, 4, 2, 128, True, 48, "bfloat16", False),
              (1, 77, 4, 4, 64, False, 0, "bfloat16", False),
              (1, 100, 4, 2, 16, True, 9, "float32", False),
              (1, 100, 4, 2, 16, False, 0, "float32", False))
# T, d, V, dtype, timed: gemma3-4b's loss head at full width and at phase
# 8's reduced shapes (a ragged last token tile), and small f32
CE_CASES = ((4096, 2560, 262144, "bfloat16", True),
            (48, 64, 512, "bfloat16", False),
            (100, 16, 300, "float32", False))
# the cross-entropy inputs' logits have this std: at the embedding's init
# scale (about 1) the softmax part of a bf16 gradient at V 262144 is below
# bf16's rounding of the one-hot part, and no reading could see it
CE_LOGIT_STD = 3.0


# the attention kernels' instructions by namespace and kernel: the bf16
# route's forward and dQ pass on wgmma, its dK/dV pass on mma.sync; the
# f32 route and the delta kernel on the CUDA cores
ATTN_ROUTES = {("tc", "attn_fwd_kernel"): "wgmma",
               ("tc", "attn_bwd_dkdv_kernel"): "mma.sync",
               ("tc", "attn_bwd_dq_kernel"): "wgmma"}
_ATTN_FN = re.compile(r"Compiling entry function '(\S*?(tc|simt)\d+"
                      r"(attn_\w+?_kernel)I(f|13__nv_bfloat16)?(?:Li(\d+)E)?\S*)'")
# the cross-entropy kernels: the bf16 route (namespace tc) on wgmma, the
# f32 route (simt) on the CUDA cores, the split merge without products;
# the boolean template argument names the variant
CE_VARIANTS = {"ce_logits_kernel": ("fwd", "bwd"),
               "ce_grad_kernel": ("dh", "de"),
               "ce_bwd_kernel": ("dw", "dh")}
_CE_FN = re.compile(r"Compiling entry function '(\S*?(tc|simt)?\d+"
                    r"(ce_\w+?_kernel)(?:ILb([01])EE)?\S*)'")
# the SSD kernels, every product on the TF32 tensor cores (3xTF32)
_SSD_FN = re.compile(r"Compiling entry function '(\S*?(ssd_(?:fwd|bwd|dbc)"
                     r"_kernel)\S*)'")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")


def ptxas_table(log: str, fn=_ATTN_FN) -> list:
    """``(groups of fn, registers, spill stores, spill loads)`` of every
    kernel instantiation whose entry matches ``fn`` in an nvcc -Xptxas -v
    log; the first group is the mangled name."""
    rows, cur = [], None
    for line in log.splitlines():
        m = fn.search(line)
        if m:
            cur = [m.groups(), None, 0, 0]
            continue
        if cur is None:
            continue
        m = _PTXAS_SPILL.search(line)
        if m:
            cur[2:4] = int(m.group(1)), int(m.group(2))
        m = _PTXAS_REGS.search(line)
        if m:
            cur[1] = int(m.group(1))
            rows.append(tuple(cur))
            cur = None
    return rows


def print_attention_build(log: str) -> None:
    """One line per attention instantiation: its instruction route,
    registers and spill bytes, from the build's ptxas output."""
    for (_, ns, name, t, d), regs, st, ld in ptxas_table(log):
        dtype = "bf16" if ns == "tc" or (t and "bfloat" in t) else "f32"
        route = ATTN_ROUTES.get((ns, name), "CUDA-core FMA")
        print(f"attention build {name} {dtype} D={d}: {route}, {regs} "
              f"registers, spill stores {st} B, spill loads {ld} B",
              flush=True)


def sass_of(lib: Path) -> dict:
    """``{mangled kernel name: its SASS}`` of a built library, by the
    toolkit's cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, check=True).stdout
    funcs = {}
    for part in out.split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        funcs[name.strip()] = body
    return funcs


def print_ce_build(log: str, lib: Path) -> None:
    """One line per cross-entropy instantiation: its route, registers and
    spill bytes (ptxas), and for the bf16 route the wgmma instructions
    (HGMMA) its SASS holds. A bf16 kernel that spills or holds none fails
    the build."""
    sass = sass_of(lib)
    rows = ptxas_table(log, _CE_FN)
    check(any(ns == "tc" for (_, ns, *_), *_ in rows),
          "the build log names the bf16 cross-entropy kernels")
    for (mangled, ns, name, b), regs, st, ld in rows:
        variant = CE_VARIANTS[name][int(b)] if b else ""
        hgmma = sass.get(mangled, "").count("HGMMA")
        route = ("wgmma" if ns == "tc" else "none (merge)"
                 if name == "ce_merge_kernel" else "CUDA-core FMA")
        dtype = "bf16" if ns == "tc" else "f32" if ns else "both"
        what = " ".join(x for x in (name, variant, dtype) if x)
        print(f"cross-entropy build {what}: {route} ({hgmma} HGMMA in "
              f"SASS), {regs} registers, spill stores {st} B, spill loads "
              f"{ld} B", flush=True)
        if ns == "tc":
            check(st == ld == 0, f"{what} spills")
            check(hgmma > 0, f"{what}: no wgmma in its SASS")


def print_ssd_build(log: str, lib: Path) -> None:
    """One line per SSD kernel: registers and spill bytes (ptxas) and the
    tensor-core products its SASS holds (HGMMA: wgmma, HMMA: mma.sync); a
    kernel without any fails the build."""
    sass = sass_of(lib)
    rows = ptxas_table(log, _SSD_FN)
    check(len(rows) == 3, f"the build log names the three SSD kernels "
          f"({len(rows)})")
    for (mangled, name), regs, st, ld in rows:
        code = sass.get(mangled, "")
        hgmma, hmma = code.count("HGMMA"), code.count("HMMA")
        print(f"ssd build {name}: 3xTF32 ({hgmma} HGMMA, {hmma} HMMA in "
              f"SASS), {regs} registers, spill stores {st} B, spill loads "
              f"{ld} B", flush=True)
        check(hgmma + hmma > 0, f"{name}: no tensor-core product in its "
              f"SASS")


def phase_attention(torch, F, fa, timing, dev, bw, bf16,
                    cases=ATTN_CASES) -> dict:
    """Attention kernels against their plain versions; times at full
    width beside the bound and scaled_dot_product_attention."""
    rows = {"flash_attention_fwd": {}, "flash_attention_bwd": {}}
    for i, (B, S, H, KVH, D, causal, window, dt, timed) in \
            enumerate(cases):
        dtype = getattr(torch, dt)
        gen = torch.Generator(device=dev).manual_seed(100 + i)
        q, k, v, do = (torch.randn(B, S, h, D, generator=gen, device=dev)
                       .to(dtype) for h in (H, KVH, KVH, H))
        args = (causal, window)
        out, lse = fa.flash_attention_fwd(q, k, v, *args)
        p_out, p_lse = fa.flash_attention_fwd_ref(q, k, v, *args)
        grads = fa.flash_attention_bwd(q, k, v, out, lse, do, *args)
        p_grads = fa.flash_attention_bwd_ref(q, k, v, out, lse, do, *args)
        torch.cuda.synchronize()
        tag = (f"B={B} S={S} H={H} KVH={KVH} D={D} causal={causal} "
               f"window={window} {dt}")
        hold(rows["flash_attention_fwd"], f"flash_attention_fwd {tag}", "fwd",
             (("out", out, p_out), ("lse", lse, p_lse)))
        hold(rows["flash_attention_bwd"], f"flash_attention_bwd {tag}", "bwd",
             tuple(zip(("dq", "dk", "dv"), grads, p_grads)))
        if not timed:
            continue
        again = fa.flash_attention_bwd(q, k, v, out, lse, do, *args)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(grads, again)),
              f"flash_attention_bwd {tag}: two calls, the same bits")
        print(f"flash_attention_bwd {tag}: two calls give the same bits",
              flush=True)
        es = q.element_size()
        pairs = B * H * attn_pairs(S, causal, window)
        qo = B * S * H * D * es
        kv = B * S * KVH * D * es
        lse_b = B * S * H * 4
        # forward: s = q·kᵀ and p·v over the unmasked pairs; backward: s
        # again, dp, dv, dq, dk (the flash backward's five products)
        b_fwd = bound(2 * qo + 2 * kv + lse_b, 4 * pairs * D, bw, bf16)
        b_bwd = bound(4 * qo + 4 * kv + lse_b, 10 * pairs * D, bw, bf16)
        # the library's same function: the (B, H, S, D) layout, GQA by
        # enable_gqa, the window as a boolean mask
        qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
        mask = None
        if window:
            ii = torch.arange(S, device=dev)
            mask = ((ii[:, None] >= ii[None, :])
                    & (ii[:, None] - ii[None, :] < window))

        def lib(qt=qt, kt=kt, vt=vt, mask=mask):
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=mask is None,
                enable_gqa=True)

        ql, kl, vl = (x.detach().requires_grad_(True) for x in (qt, kt, vt))
        lib_out = lib(ql, kl, vl)
        t = {
            "fwd": timing.cuda_time_ms(
                lambda: fa.flash_attention_fwd(q, k, v, *args), reps=10),
            "fwd_plain": timing.cuda_time_ms(
                lambda: fa.flash_attention_fwd_ref(q, k, v, *args), reps=5),
            "fwd_lib": timing.cuda_time_ms(lib, reps=10),
            "bwd": timing.cuda_time_ms(
                lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, *args),
                reps=10),
            "bwd_plain": timing.cuda_time_ms(
                lambda: fa.flash_attention_bwd_ref(q, k, v, out, lse, do,
                                                   *args), reps=3),
            "bwd_lib": timing.cuda_time_ms(
                lambda: torch.autograd.grad(lib_out, (ql, kl, vl), dot,
                                            retain_graph=True), reps=10),
        }
        suffix = "" if window == 0 else f"_window{window}"
        for name, kind, (b_ms, by) in (("flash_attention_fwd", "fwd", b_fwd),
                                       ("flash_attention_bwd", "bwd", b_bwd)):
            rows[name].update({
                "ms" + suffix: t[kind],
                "plain_ms" + suffix: t[kind + "_plain"],
                "library_ms" + suffix: t[kind + "_lib"],
                "bound_ms" + suffix: b_ms, "bound_by" + suffix: by})
            print(f"{name} {tag}: kernel {t[kind]:.4f} ms, plain "
                  f"{t[kind + '_plain']:.4f} ms, scaled_dot_product_attention "
                  f"{t[kind + '_lib']:.4f} ms, bound {b_ms:.4f} ms ({by})",
                  flush=True)
    rows["flash_attention_fwd"].update(
        replaces="src/repro/kernels/flash_attention.py:75",
        products="bf16: wgmma; f32: CUDA-core FMA")
    rows["flash_attention_bwd"].update(
        replaces="src/repro/models/attention.py:222",
        products="bf16: dK/dV mma.sync, dQ wgmma; f32: CUDA-core FMA")
    return rows


_KERNEL_NAME = re.compile(r"(\w+_kernel(?:<[^>]*>)?)")


def kernel_times(torch, fn, ms: float) -> str:
    """Device time of one ``fn()`` by kernel (torch.profiler's CUDA
    trace of the second of two calls), as ``name ms (launches)`` pairs,
    longest first, and their sum beside ``ms``, the call's CUDA-event
    time: the trace can miss kernels."""
    from torch.profiler import ProfilerActivity, profile, schedule
    traced = []
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: traced.extend(p.key_averages())
                 ) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    parts = []
    for ev in traced:
        us = getattr(ev, "device_time_total", 0) or 0
        if us > 0:
            m = _KERNEL_NAME.search(ev.key)
            parts.append((us, m.group(1) if m else ev.key[:40], ev.count))
    if not parts:
        return "not measured (no device events)"
    return (", ".join(f"{n} {us / 1e3:.4f} ms ({c})"
                      for us, n, c in sorted(parts, reverse=True))
            + f"; traced {sum(p[0] for p in parts) / 1e3:.4f} of the "
            f"{ms:.4f} ms CUDA events time")


def phase_cross_entropy(torch, F, ce, timing, dev, bw, bf16,
                        cases=CE_CASES, rows=None, suffix="") -> dict:
    """Cross-entropy kernels against their plain versions; times at full
    width beside the bound and the two-call library form. Given ``rows``
    (an earlier call's), the readings join them and the timings go under
    ``<key><suffix>``."""
    rows = rows or {"fused_ce_fwd": {}, "fused_ce_bwd": {}}
    for i, (T, d, V, dt, timed) in enumerate(cases):
        dtype = getattr(torch, dt)
        gen = torch.Generator(device=dev).manual_seed(200 + i)
        h = torch.randn(T, d, generator=gen, device=dev).to(dtype)
        # w = eᵀ with e (V, d) contiguous: the tied embedding's layout
        e = (torch.randn(V, d, generator=gen, device=dev)
             * (CE_LOGIT_STD / math.sqrt(d))).to(dtype)
        w = e.t()
        y = torch.randint(0, V, (T,), generator=gen, device=dev)
        g = torch.rand(T, generator=gen, device=dev)
        loss, lse, pred = ce.fused_ce_fwd(h, w, y)
        p_loss, p_lse, p_pred = ce.fused_ce_fwd_ref(h, w, y)
        dh, dw = ce.fused_ce_bwd(h, w, y, lse, g)
        p_dh, p_dw = ce.fused_ce_bwd_ref(h, w, y, lse, g)
        torch.cuda.synchronize()
        tag = f"T={T} d={d} V={V} {dt}"
        # an argmax may differ only where the top logits tie within the
        # rounding of two f32 sums
        off = (pred != p_pred).nonzero().flatten()
        if off.numel():
            logits = h[off].float() @ w.float()
            top = logits.max(dim=-1).values
            picked = logits.gather(1, pred[off, None])[:, 0]
            check(bool(((top - picked) <= 1e-5 * (1 + top.abs())).all()),
                  f"fused_ce_fwd {tag}: argmax off by more than a tie")
        print(f"fused_ce_fwd {tag}: argmax differs on {off.numel()} of {T} "
              f"tokens (ties)", flush=True)
        # the one-hot part of each gradient, -g_t·e[y_t] in dh and
        # -Σ g_t·h_t in the target's column of dw, in f32: what is left of
        # the plain gradient, its softmax part, is held on its own
        hot_dh = -(g[:, None] * e.float()[y])
        hot_dw = torch.zeros((V, d), device=dev).index_add_(
            0, y, -(g[:, None] * h.float())).t()
        soft_dh, soft_dw = p_dh.float() - hot_dh, p_dw.float() - hot_dw
        hold(rows["fused_ce_fwd"], f"fused_ce_fwd {tag}", "fwd",
             (("loss", loss, p_loss), ("lse", lse, p_lse)))
        hold(rows["fused_ce_bwd"], f"fused_ce_bwd {tag}", "bwd",
             (("dh", dh, p_dh), ("dw", dw, p_dw),
              ("dh's softmax part", dh, p_dh, soft_dh),
              ("dw's softmax part", dw, p_dw, soft_dw)))
        if not timed:
            continue
        again = ce.fused_ce_bwd(h, w, y, lse, g)
        torch.cuda.synchronize()
        check(torch.equal(dh, again[0]) and torch.equal(dw, again[1]),
              f"fused_ce_bwd {tag}: two calls, the same bits")
        del again
        print(f"fused_ce_bwd {tag}: two calls give the same bits", flush=True)
        if dtype == torch.bfloat16:
            print(f"fused_ce_bwd {tag}: vocab chunk {ce.vocab_chunk(T, V)}, "
                  f"buffers {ce.bwd_scratch_bytes(T, V, d) / 2**20:.1f} MiB "
                  f"for the call", flush=True)
        # what the limits reject: the gradients of a kernel that dropped
        # the softmax work, and of one whose lse is off by log 0.8 (a fifth
        # of the vocabulary lost), which also moves lse itself
        f_dh, f_dw = ce.fused_ce_bwd_ref(h, w, y, p_lse + math.log(0.8), g)
        faults = (
            ("lse off by log 0.8", rel_norm(p_lse + math.log(0.8), p_lse),
             LIMIT_F32["fwd"]),
            ("dh without its softmax part", rel_norm(
                hot_dh.to(dtype), p_dh, soft_dh), LIMIT_BF16),
            ("dw without its softmax part", rel_norm(
                hot_dw.to(dtype), p_dw, soft_dw), LIMIT_BF16),
            ("dh with lse off by log 0.8", rel_norm(f_dh, p_dh, soft_dh),
             LIMIT_BF16),
            ("dw with lse off by log 0.8", rel_norm(f_dw, p_dw, soft_dw),
             LIMIT_BF16))
        del f_dh, f_dw
        for what, reading, limit in faults:
            check(reading > limit, f"{tag}: {what} reads {reading:.3e}, "
                  f"within the limit {limit:g}")
            print(f"fused_ce {tag}: {what} would read {reading:.3e} "
                  f"(limit {limit:g})", flush=True)
        del hot_dh, hot_dw, soft_dh, soft_dw
        es = h.element_size()
        flop = 2.0 * T * d * V
        b_fwd = bound(T * d * es + d * V * es + T * 8 + T * (4 + 4 + 8),
                      flop, bw, bf16)
        # backward: logits again, dh = dlogits·wᵀ, dw = hᵀ·dlogits
        b_bwd = bound(2 * (T * d * es + d * V * es) + T * (8 + 4 + 4),
                      3 * flop, bw, bf16)
        t = {
            "fwd": timing.cuda_time_ms(lambda: ce.fused_ce_fwd(h, w, y),
                                       reps=5, warmup=1),
            "fwd_plain": timing.cuda_time_ms(
                lambda: ce.fused_ce_fwd_ref(h, w, y), reps=5, warmup=1),
            "bwd": timing.cuda_time_ms(
                lambda: ce.fused_ce_bwd(h, w, y, lse, g), reps=3, warmup=1),
            "bwd_plain": timing.cuda_time_ms(
                lambda: ce.fused_ce_bwd_ref(h, w, y, lse, g), reps=3,
                warmup=1),
            "fwd_lib": timing.cuda_time_ms(
                lambda: F.cross_entropy(h @ w, y), reps=5, warmup=1),
        }
        # the library's yardstick: no single PyTorch call computes the
        # fused function, so the two-call form F.cross_entropy(h @ W, y)
        # and its autograd backward, on a graph built once
        hl, wl = (x.detach().requires_grad_(True) for x in (h, w))
        lib_loss = F.cross_entropy(hl @ wl, y, reduction="none")
        t["bwd_lib"] = timing.cuda_time_ms(
            lambda: torch.autograd.grad(lib_loss, (hl, wl),
                                        g.to(lib_loss.dtype),
                                        retain_graph=True), reps=3, warmup=1)
        del lib_loss, hl, wl
        for name, kind, fn in (
                ("fused_ce_fwd", "fwd", lambda: ce.fused_ce_fwd(h, w, y)),
                ("fused_ce_bwd", "bwd",
                 lambda: ce.fused_ce_bwd(h, w, y, lse, g))):
            print(f"{name} {tag}: by kernel "
                  f"{kernel_times(torch, fn, t[kind])}", flush=True)
        for name, kind, (b_ms, by) in (("fused_ce_fwd", "fwd", b_fwd),
                                       ("fused_ce_bwd", "bwd", b_bwd)):
            rows[name].update({
                "ms" + suffix: t[kind],
                "plain_ms" + suffix: t[kind + "_plain"],
                "bound_ms" + suffix: b_ms, "bound_by" + suffix: by,
                "library_ms" + suffix: t[kind + "_lib"]})
            lib = "F.cross_entropy(h @ W, y)" + (
                " backward" if kind == "bwd" else "")
            print(f"{name} {tag}: kernel {t[kind]:.4f} ms, plain "
                  f"{t[kind + '_plain']:.4f} ms, two calls {lib} "
                  f"{t[kind + '_lib']:.4f} ms ({t[kind + '_lib'] / t[kind]:.2f}"
                  f"x the kernel's time), bound {b_ms:.4f} ms ({by})",
                  flush=True)
    rows["fused_ce_fwd"]["replaces"] = "src/repro/kernels/fused_ce.py:67"
    rows["fused_ce_bwd"]["replaces"] = "src/repro/models/transformer.py:302"
    return rows


@contextlib.contextmanager
def plain_versions(*modules):
    """Route the autograd functions through the plain versions on the card
    (the wrappers themselves never fall back): in each kernel module, every
    wrapper ``f`` with a ``f_ref`` beside it is replaced by ``f_ref``."""
    saved = [(m, name, getattr(m, name)) for m in modules
             for name in dir(m) if hasattr(m, name + "_ref")
             and hasattr(getattr(m, name), "launches")]
    for m, name, _ in saved:
        setattr(m, name, getattr(m, name + "_ref"))
    try:
        yield
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)


def phase_full_width(torch, np, cfg, S, tfm, common, kernel_mods, kernels,
                     timing, dev, held_dtype=None, variant=None) -> dict:
    """An LM at full width, B 1, S 4096 (gemma3-4b at 6 layers; mamba2-780m
    at all 48): loss and gradient through the kernels against the plain
    versions, with exact launch counts per gradient.

    With ``held_dtype``, the config's own (bf16) gradient is timed and its
    loss held, but its gradient is read, not held: beside it stands the
    reading of the plain path against itself with ``variant`` (a context
    that swaps in a second, more exact plain version), which is how far
    two valid evaluations of that gradient lie apart at this depth. The
    gradient is then held at ``held_dtype`` compute."""
    n = tfm.n_params(cfg)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    init = common.init_params(tfm.model_defs(cfg),
                              torch.Generator(device=dev).manual_seed(0),
                              device=dev)
    leaf = torch.cat([t.reshape(-1) for _, t in
                      common.tree_leaves_with_path(init)])
    del init
    tok = torch.from_numpy(np.random.RandomState(7).randint(
        0, cfg.vocab_size, size=(1, S + 1))).to(dev)
    batch = {"tokens": tok[:, :-1], "targets": tok[:, 1:],
             "mask": torch.ones((1, S), device=dev)}

    def gradient(c=cfg):
        w = leaf.detach().requires_grad_(True)
        loss, metrics = tfm.lm_loss(c, tfm.unflatten(w, c), batch)
        loss.backward()
        return loss.detach(), w.grad, metrics

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    loss_k, grad_k, metrics = gradient()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    want = lm_counts(cfg, 1)
    check(counts == want, f"launches per full-width gradient {counts}")
    peak = torch.cuda.max_memory_allocated()

    def timed_ms(reps=3):
        """Median host time of ``reps`` synchronised gradients: on this
        eager path one gradient alone drifts from run to run by more than
        a kernel's share of it (PERF.md §7)."""
        times = []
        for _ in range(reps):
            with timing.Timer("cuda") as tm:
                gradient()
            times.append(1e3 * tm.elapsed)
        return statistics.median(times), times

    ms, ms_all = timed_ms()
    with plain_versions(*kernel_mods):
        loss_p, grad_p, _ = gradient()
        plain_ms, plain_all = timed_ms()
    rel_loss = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    rel_grad = (torch.linalg.vector_norm(grad_k - grad_p)
                / torch.linalg.vector_norm(grad_p)).item()
    check(math.isfinite(loss_k.item())
          and bool(torch.isfinite(grad_k).all()),
          "full-width loss and gradient finite")
    check(rel_loss <= 1e-3, f"full-width loss kernels vs plain {rel_loss:.3e}")
    out = {"params": n, "loss": loss_k.item(), "loss_plain": loss_p.item(),
           "rel_loss": rel_loss, "rel_grad": rel_grad, "ms": ms,
           "ms_all": ms_all, "plain_ms": plain_ms, "plain_ms_all": plain_all,
           "peak_bytes": peak,
           "accuracy": metrics["accuracy"].item(), "launches": counts}
    held = "limit 2e-2"
    if held_dtype is None:
        check(rel_grad <= 2e-2, f"full-width gradient kernels vs plain "
              f"{rel_grad:.3e}")
    else:
        with plain_versions(*kernel_mods), variant():
            _, grad_v, _ = gradient()
        out["rel_grad_variant"] = rel_norm(grad_v, grad_p)
        held = (f"read, not held; the plain path against its more exact "
                f"variant reads {out['rel_grad_variant']:.3e}")
    print(f"full width {cfg.name} {cfg.n_layers} layers n={n} B=1 S={S} "
          f"{str(cfg.compute_dtype)[6:]} compute: loss kernels "
          f"{out['loss']:.6f} plain {out['loss_plain']:.6f} (rel "
          f"{rel_loss:.3e}, limit 1e-3), gradient rel norm {rel_grad:.3e} "
          f"({held}); {ms:.1f} ms per gradient through the kernels "
          f"(median of {[round(v, 1) for v in ms_all]}), {plain_ms:.1f} ms "
          f"through the plain versions (median of "
          f"{[round(v, 1) for v in plain_all]}); peak "
          f"{peak / 2**30:.2f} GiB (max_memory_allocated); launches per "
          f"gradient {counts}", flush=True)
    if held_dtype is not None:
        del grad_k, grad_p, grad_v
        torch.cuda.empty_cache()
        held_cfg = dataclasses.replace(cfg, compute_dtype=held_dtype)
        loss_k, grad_k, _ = gradient(held_cfg)
        with plain_versions(*kernel_mods):
            loss_p, grad_p, _ = gradient(held_cfg)
        out["held"] = {
            "dtype": str(held_dtype),
            "rel_loss": abs(loss_k.item() - loss_p.item()) / abs(
                loss_p.item()),
            "rel_grad": rel_norm(grad_k, grad_p)}
        check(bool(torch.isfinite(grad_k).all()), "held gradient finite")
        check(out["held"]["rel_loss"] <= 1e-3, f"full-width loss at "
              f"{held_dtype} kernels vs plain {out['held']['rel_loss']:.3e}")
        check(out["held"]["rel_grad"] <= 2e-2, f"full-width gradient at "
              f"{held_dtype} kernels vs plain {out['held']['rel_grad']:.3e}")
        print(f"full width {cfg.name} {cfg.n_layers} layers "
              f"{str(held_dtype)[6:]} compute: loss kernels "
              f"{loss_k.item():.6f} plain {loss_p.item():.6f} (rel "
              f"{out['held']['rel_loss']:.3e}, limit 1e-3), gradient rel "
              f"norm {out['held']['rel_grad']:.3e} (limit 2e-2)", flush=True)
    return out


@contextlib.contextmanager
def f64_plain_ssd(sc):
    """Inside ``plain_versions``: the SSD plain versions on f64 copies of
    their inputs, rounded back to f32 (the same function, more exactly)."""
    saved = sc.ssd_intra_fwd, sc.ssd_intra_bwd

    def fwd(a, x, b, c, chunk):
        return sc.ssd_intra_fwd_ref(a.double(), x.double(), b.double(),
                                    c.double(), chunk).float()

    def bwd(a, x, b, c, dy, chunk):
        return tuple(t.float() for t in sc.ssd_intra_bwd_ref(
            a.double(), x.double(), b.double(), c.double(), dy.double(),
            chunk))

    sc.ssd_intra_fwd, sc.ssd_intra_bwd = fwd, bwd
    try:
        yield
    finally:
        sc.ssd_intra_fwd, sc.ssd_intra_bwd = saved


def phase_lm_main_path(torch, runtime, zoo, kernels, comm_rounds,
                       EASGDConfig, timing, cfg, arch="gemma3-4b",
                       algos=("sync_easgd", "sync_sgd"),
                       device="cuda") -> dict:
    """``--model <arch>`` (the reduced config ``cfg``) on the PS trainer,
    P = 4, ring, 64 KiB buckets, 16 rounds; counters 0 before each run and
    read just after. First the time of one gradient alone, on a private
    minibatch stream, to set a round's four gradients against the round."""
    p, rounds = 4, 16
    easgd = EASGDConfig(eta=0.05, rho=0.05, mu=MU)
    problem = zoo.resolve(arch)
    w0, grad_fn, _ = problem.build(device)
    n = w0.numel()
    grad_fn(w0, 0, -9)                                   # warm-up
    with timing.Timer(device) as tm:
        for k in range(10):
            grad_fn(w0, k, -9)
    print(f"{arch} reduced gradient (n={n}) alone: "
          f"{1e3 * tm.elapsed / 10:.2f} ms per gradient", flush=True)
    bounds = comm_rounds.default_bucket_boundaries(
        grad_fn.layer_sizes, n + (-n) % p, 64 << 10)
    # every worker warms up on 2 gradients, then takes one per round; the
    # run ends with one eval (a forward without backward)
    grads, evals = 2 * p + rounds * p, 1
    totals = {k.__name__: 0 for k in kernels.KERNELS}
    updates = {"sync_easgd": ("fused_sync_easgd_update", p * rounds),
               "sync_sgd": ("fused_sync_sgd_update", rounds)}
    for algo in algos:
        update, n_update = updates[algo]
        ps_cfg = runtime.PSConfig(algorithm=algo, n_workers=p,
                                  total_iters=p * rounds, schedule="ring",
                                  eval_every_iters=10**9,
                                  bucket_bytes=64 << 10)
        kernels.reset_launch_counts()
        res = runtime.run_ps(problem, easgd, ps_cfg, device=device)
        counts = kernels.launch_counts()
        expected = lm_counts(cfg, grads, evals)
        expected[update] = n_update
        check(counts == expected, f"{algo} on {arch} launched {counts}, "
              f"expected {expected}")
        check(res.center.numel() == n and bool(
            torch.isfinite(res.center).all()) and bool(
            torch.isfinite(res.workers).all())
            and math.isfinite(res.final_metric), f"{algo} finite result")
        for k, v in counts.items():
            totals[k] += v
        us = 1e6 * res.total_time_s / res.total_iters
        print(f"main path {algo} {arch} reduced n={n} P={p} ring "
              f"bucket=64KiB ({len(bounds) - 1} buckets): {res.total_iters} "
              f"iters in {res.total_time_s:.3f} s = {us:.1f} us/iter, final "
              f"eval loss {res.final_metric:.4f}, counters {res.counters}, "
              f"launches {counts}", flush=True)
    return totals


# ---------------------------------------------------------------------------
# the multi-pod slice: the packed Sync EASGD step and fused_elastic_update
# ---------------------------------------------------------------------------

# storage dtypes of (W, V, G, C, M): the update's inputs as the step holds
# them, with ElasticConfig's momentum and center dtypes at f32 and at bf16
ELASTIC_MIXES = (("all f32", ("float32",) * 5),
                 ("params f32, momentum and center bf16",
                  ("float32", "bfloat16", "float32", "bfloat16", "float32")),
                 ("all bf16", ("bfloat16",) * 5))


def elastic_bound(p: int, n: int, sizes, bw, f32) -> tuple:
    """Bound of one fused_elastic_update on P pod rows of n elements whose
    (W, V, G, C, M) are stored in ``sizes`` bytes per element: W, V and C
    read and written, G and M read; per element index 7 operations for
    each pod (V' 3, W' 4) and 3 for C'."""
    w, v, g, c, m = sizes
    n_bytes = p * n * (2 * w + 2 * v + g) + n * (2 * c + m)
    return bound(n_bytes, (7 * p + 3) * n, bw, f32)


def phase_elastic_kernel(torch, eu, timing, dev, bw, f32,
                         sizes=(1188, 131072 + 777, N_ALEXNET),
                         timed_n=1 << 28) -> dict:
    """fused_elastic_update against its plain version on the card, bit for
    bit, over n, P and the storage dtypes; both timed at P = 2, f32,
    n = 2^28 beside the bytes bound."""
    gen = torch.Generator(device=dev).manual_seed(13)

    def inputs(p, n, dtypes):
        shapes = [(n,)] * 5 if p == 1 else [(p, n)] * 3 + [(n,)] * 2
        return [torch.randn(s, generator=gen, device=dev).to(getattr(torch, d))
                for s, d in zip(shapes, dtypes)]

    for n in sizes:
        for p in (1, 2, 4):
            for label, dtypes in ELASTIC_MIXES:
                xs = inputs(p, n, dtypes)
                k, pl = [x.clone() for x in xs], [x.clone() for x in xs]
                eu.fused_elastic_update(*k, eta=ETA, rho=RHO, mu=MU,
                                        n_workers=p)
                eu.fused_elastic_update_ref(*pl, eta=ETA, rho=RHO, mu=MU,
                                            n_workers=p)
                torch.cuda.synchronize()
                check(all(torch.equal(k[i], pl[i]) and k[i].dtype == xs[i].dtype
                          for i in (0, 1, 3)),
                      f"fused_elastic_update == plain, n={n} P={p} {label}")
        print(f"fused_elastic_update == plain version at n={n} (P=1, 2, 4; "
              f"{'; '.join(lb for lb, _ in ELASTIC_MIXES)}): bitwise",
              flush=True)
    p, n = 2, timed_n
    xs = inputs(p, n, ELASTIC_MIXES[0][1])
    kw = dict(eta=ETA, rho=RHO, mu=MU, n_workers=p)
    t = {"kernel": timing.cuda_time_ms(
             lambda: eu.fused_elastic_update(*xs, **kw), reps=10),
         "plain": timing.cuda_time_ms(
             lambda: eu.fused_elastic_update_ref(*xs, **kw), reps=10)}
    b_ms, by = elastic_bound(p, n, [x.element_size() for x in xs], bw, f32)
    del xs
    print(f"fused_elastic_update P={p} n={n} f32: kernel {t['kernel']:.4f} "
          f"ms, plain {t['plain']:.4f} ms, bound {b_ms:.4f} ms ({by}); "
          f"{b_ms / t['kernel']:.1%} of the bound", flush=True)
    return {"fused_elastic_update": {
        "replaces": "src/repro/kernels/elastic_update.py:45",
        "max_abs_err": 0.0, "ms": t["kernel"], "plain_ms": t["plain"],
        "bound_ms": b_ms, "bound_by": by, "library_ms": None,
        "shape": f"P={p} n={n} f32"}}


@contextlib.contextmanager
def watch_update(elastic, eu, torch, sl):
    """Route the step's update through a spy that brackets each kernel
    launch with CUDA events and, on the first call, copies the ``sl`` slice
    of its inputs (W, V, G, C and the pod mean M). The launch itself is the
    wrapper's, so its count is the step's."""
    seen = {"events": [], "inputs": None}

    def spy(w, v, g, c, mean_w, **kw):
        if seen["inputs"] is None:
            seen["inputs"] = [w[:, sl].clone(), v[:, sl].clone(),
                              g[:, sl].clone(), c[sl].clone(),
                              mean_w[sl].clone()]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        eu.fused_elastic_update(w, v, g, c, mean_w, **kw)
        end.record()
        seen["events"].append((start, end))

    saved = elastic.eu
    elastic.eu = types.SimpleNamespace(fused_elastic_update=spy)
    try:
        yield seen
    finally:
        elastic.eu = saved


def lm_counts(cfg, grads: int, evals: int = 0, updates: int = 0) -> dict:
    """The launches ``grads`` LM gradients and ``evals`` forward passes
    imply: per pass one attention (``attn`` / ``local`` layers) or SSD
    (``ssm`` layers) forward per layer and one cross-entropy forward, and
    for a gradient the backwards too; the packed update ``updates`` times;
    the f64 updates none."""
    kinds = cfg.layer_kinds()
    attn = sum(k in ("attn", "local") for k in kinds)
    ssd = sum(k == "ssm" for k in kinds)
    check(attn + ssd == len(kinds), f"layer kinds {set(kinds)}")
    return {"fused_sync_easgd_update": 0, "fused_sync_sgd_update": 0,
            "flash_attention_fwd": attn * (grads + evals),
            "flash_attention_bwd": attn * grads,
            "fused_ce_fwd": grads + evals, "fused_ce_bwd": grads,
            "fused_elastic_update": updates,
            "ssd_intra_fwd": ssd * (grads + evals),
            "ssd_intra_bwd": ssd * grads}



def phase_multi_pod(torch, np, cfg, S, elastic, EASGDConfig, train,
                    synthetic, eu, kernels, timing, dev, bw, f32) -> tuple:
    """A main path at full width: the packed multi-pod Sync EASGD step on
    ``cfg`` (gemma3-4b at 6 layers; mamba2-780m at all 48), P = 2, B 1 per
    pod, S 4096, psum, overlap on, 3 steps; counters 0 before each step and
    read after."""
    p, steps = 2, 3
    ecfg = elastic.ElasticConfig(easgd=EASGDConfig(eta=ETA, rho=RHO, mu=MU),
                                 schedule="psum", overlap=True)
    torch.cuda.empty_cache()
    build = train.build_train_step(cfg, ecfg, n_pods=p, per_pod_batch=1,
                                   seq=S, device=dev)
    state = build.init_state()
    n = state.params.shape[1]
    check(state.params.shape == (p, n) and state.center.shape == (n,),
          "state rows")
    streams = [synthetic.SyntheticLMStream(cfg.vocab_size, S, 1, seed=13,
                                           shard=i, n_shards=p)
               for i in range(p)]
    lo = n // 2
    sl = slice(lo, lo + (1 << 20))
    totals = {k.__name__: 0 for k in kernels.KERNELS}
    ms, losses = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with watch_update(elastic, eu, torch, sl) as seen:
        for s in range(steps):
            shards = [st.batch_at(s) for st in streams]
            batch = {k: np.stack([sh[k] for sh in shards]) for k in shards[0]}
            kernels.reset_launch_counts()
            with timing.Timer("cuda") as tm:
                state, metrics = build.step(state, batch)
            counts = kernels.launch_counts()
            want = lm_counts(cfg, p, updates=1)     # one gradient per pod
            check(counts == want, f"multi-pod step {s} launched {counts}, "
                  f"expected {want}")
            for k, v in counts.items():
                totals[k] += v
            ms.append(1e3 * tm.elapsed)
            losses.append(metrics["loss"].item())
            check(math.isfinite(losses[-1]), f"step {s} loss finite")
            if s == 0:
                # the step's own update on its own inputs, against the plain
                # version on the copies taken just before the launch
                plain = seen["inputs"]
                eu.fused_elastic_update_ref(*plain, eta=ETA, rho=RHO, mu=MU,
                                            n_workers=p)
                check(torch.equal(state.params[:, sl], plain[0])
                      and torch.equal(state.momentum[:, sl], plain[1])
                      and torch.equal(state.center[sl], plain[3]),
                      "step 1's update == plain version on its inputs")
                del plain, seen["inputs"]
                seen["inputs"] = ()
            print(f"multi-pod step {s + 1}: loss {losses[-1]:.6f} acc "
                  f"{metrics['accuracy'].item():.4f}, {ms[-1]:.1f} ms, "
                  f"launches {counts}", flush=True)
        torch.cuda.synchronize()
        update_ms = sorted(a.elapsed_time(b) for a, b in seen["events"])
    peak = torch.cuda.max_memory_allocated()
    check(bool(torch.isfinite(state.params).all())
          and bool(torch.isfinite(state.center).all()), "finite state")
    # the exchange alone, on the main stream: delta = W - C, the psum over
    # the pod rows, / P, + C (what the step runs on its second stream)
    ex_ms = timing.cuda_time_ms(
        lambda: elastic.start_exchange(state, ecfg, build.exchange_plan),
        reps=5, warmup=1)
    ex_bound, _ = bound(4 * (p + 2) * n, (2 * p + 1) * n, bw, f32)
    # G and M are f32 (the step's gradient rows and pod mean)
    up_bound, up_by = elastic_bound(
        p, n, (state.params.element_size(), state.momentum.element_size(), 4,
               state.center.element_size(), 4), bw, f32)
    step_ms = statistics.median(ms[1:])
    out = {"params": n, "n_pods": p, "seq": S, "losses": losses,
           "step_ms": step_ms, "step_ms_all": ms,
           "update_ms": statistics.median(update_ms),
           "update_bound_ms": up_bound, "exchange_ms": ex_ms,
           "exchange_bound_ms": ex_bound, "peak_bytes": peak}
    print(f"main path multi-pod sync_easgd {cfg.name} {cfg.n_layers} layers "
          f"n={n} P={p} B=1 S={S} psum overlap: {step_ms:.1f} ms per step "
          f"(median of steps 2-{steps}; all {[round(x, 1) for x in ms]}); "
          f"update kernel in the step {out['update_ms']:.3f} ms, bound "
          f"{up_bound:.3f} ms ({up_by}; {up_bound / out['update_ms']:.1%}); "
          f"exchange alone {ex_ms:.3f} ms (bound {ex_bound:.3f} ms); peak "
          f"{peak / 2**30:.2f} GiB (max_memory_allocated); losses "
          f"{[round(x, 6) for x in losses]}", flush=True)
    return out, totals


def phase_launcher_path(torch, np, configs, elastic, EASGDConfig, train,
                        launcher, kernels, dev, arch="gemma3-4b",
                        compressions=("none", "bf16")) -> dict:
    """The launcher's path at reduced width: ``arch`` reduced, P = 4, B 2
    per pod in 2 microbatches, τ = 2, ring, 4 steps, each compression of
    ``compressions``; overlap on and off give the same bits on the card,
    and the card's state equals a CPU run of the same steps from the same
    state (loss 1e-3 relative, params by relative norm 2e-2: the LM
    gradient's limits). Then ``launch.train --mode sync`` itself on the
    card."""
    cfg = configs.get(arch).reduced
    p, B, micro, tau, steps, S = 4, 2, 2, 2, 4, 24
    rng = np.random.RandomState(0)
    batches = [{"tokens": rng.randint(0, cfg.vocab_size, (p, B, S)),
                "targets": rng.randint(0, cfg.vocab_size, (p, B, S)),
                "mask": np.ones((p, B, S), np.float32)} for _ in range(steps)]
    totals = {k.__name__: 0 for k in kernels.KERNELS}
    # one gradient per pod and microbatch each step
    want = lm_counts(cfg, p * micro * steps)
    want["fused_elastic_update"] = steps // tau
    for comp in compressions:
        runs = []
        for where, overlap in (("cpu", True), (dev, True), (dev, False)):
            ecfg = elastic.ElasticConfig(
                easgd=EASGDConfig(eta=0.05, rho=0.05, mu=MU, tau=tau),
                schedule="ring", compression=comp, overlap=overlap)
            build = train.build_train_step(cfg, ecfg, n_pods=p,
                                           per_pod_batch=B, seq=S,
                                           microbatches=micro, device=where)
            if where == "cpu":
                init = build.init_state()
            state = init.to(where)
            kernels.reset_launch_counts()
            losses = []
            for b in batches:
                state, metrics = build.step(state, b)
                losses.append(metrics["loss"].item())
            counts = kernels.launch_counts()
            if where == "cpu":
                check(not any(counts.values()), f"CPU run launched {counts}")
            else:  # the launch-count check: the runs on the card
                check(counts == want, f"{comp} overlap={overlap} launched "
                      f"{counts}, expected {want}")
                for k, v in counts.items():
                    totals[k] += v
            runs.append((state.to("cpu"), losses))
        (cpu, cpu_losses), (on, on_losses), (off, _) = runs
        for name in ("params", "momentum", "center", "ef_error"):
            a, b = getattr(on, name), getattr(off, name)
            check((a is None and b is None) or torch.equal(a, b),
                  f"{comp}: overlap on and off, the same {name}")
        # the compression ran: its error feedback holds the rounding
        check((on.ef_error is None) == (comp == "none") and (
            comp == "none" or bool(on.ef_error.abs().max() > 0)),
            f"{comp}: error feedback")
        rel_loss = max(abs(a - b) / abs(b)
                       for a, b in zip(on_losses, cpu_losses))
        rel_params = rel_norm(on.params, cpu.params)
        check(rel_loss <= 1e-3, f"{comp}: loss card vs CPU {rel_loss:.3e}")
        check(rel_params <= 2e-2, f"{comp}: params card vs CPU "
              f"{rel_params:.3e}")
        print(f"main path multi-pod {cfg.name} P={p} B={B} micro={micro} "
              f"tau={tau} ring compression={comp}: overlap on == off, "
              f"bitwise; card vs CPU loss rel {rel_loss:.3e} (limit 1e-3), "
              f"params rel norm {rel_params:.3e} (limit 2e-2); losses "
              f"{[round(x, 5) for x in on_losses]}; launches {want}",
              flush=True)
    # the entry point a user calls, as the docs give it; it sets the counts
    # to 0 before its loop, and they are read just after it returns
    losses = launcher.main([
        "--arch", arch, "--reduced", "--n-pods", str(p), "--batch",
        str(p * B), "--seq", str(S), "--steps", str(steps), "--tau",
        str(tau), "--microbatches", str(micro), "--schedule", "ring",
        "--log-every", "1", "--device", str(torch.device(dev).type)])
    counts = kernels.launch_counts()
    check(counts == want, f"launcher launched {counts}, expected {want}")
    check(len(losses) == steps and all(map(math.isfinite, losses)),
          "launcher losses finite")
    for k, v in counts.items():
        totals[k] += v
    return totals


# ---------------------------------------------------------------------------
# the Mamba-2 slice: the SSD intra-chunk kernels
# ---------------------------------------------------------------------------

# B, H, S, P, N, L, scale of the log-decay, timed: mamba2-780m's layer at
# full width; phase 15's reduced shapes (S 24 padded to 32); a chunk whose
# cumulative decay falls far below -88
SSD_CASES = ((1, 48, 4096, 64, 128, 256, 1.0, True),
             (2, 8, 32, 16, 16, 16, 1.0, False),
             (1, 2, 256, 16, 16, 128, 2.0, False))
# the cross-entropy at mamba2-780m's loss head: T 4096, d 1536, V 50280
# (a ragged last vocab tile), bf16
CE_MAMBA2_CASES = ((4096, 1536, 50280, "bfloat16", True),)


def ssd_bound(B, H, S, P, N, L, bw, rate, products=1) -> tuple:
    """Bounds of ``ssd_intra_fwd`` and ``ssd_intra_bwd`` on these shapes:
    each input read once and each output written once, in f32; over the
    L (L + 1) / 2 causal pairs of each chunk, 2 operations per product
    term: G = C·Bᵀ once per (batch row, chunk) and M·X per head forward
    (N + H·P per pair); G again, dC, dB and, per head, dX and dM backward
    (3 N + 2 H·P); each product ``products`` times at ``rate`` (3 at the
    TF32 rate for the kernels' 3xTF32 route, 1 at the CUDA cores' f32
    rate)."""
    nc, pairs = S // L, L * (L + 1) // 2
    a, x, bc = 4 * B * H * S, 4 * B * H * S * P, 4 * B * S * N
    fwd = bound(a + 2 * x + 2 * bc,
                products * 2 * B * nc * pairs * (N + H * P), bw, rate)
    bwd = bound(2 * a + 3 * x + 4 * bc,
                products * 2 * B * nc * pairs * (3 * N + 2 * H * P), bw,
                rate)
    return fwd, bwd


def phase_ssd(torch, sc, timing, dev, bw, f32, tf32,
              cases=SSD_CASES) -> dict:
    """The SSD kernels against their plain versions on the card, each
    output by its relative norm (y at 1e-5, dx, db, dc and da at 1e-4);
    at full width both timed beside the bound (3xTF32) and the CUDA-core
    f32 bound, and by kernel."""
    rows = {"ssd_intra_fwd": {}, "ssd_intra_bwd": {}}
    for i, (B, H, S, P, N, L, scale, timed) in enumerate(cases):
        gen = torch.Generator(device=dev).manual_seed(300 + i)
        a = -scale * torch.nn.functional.softplus(
            torch.randn(B * H, S, generator=gen, device=dev))
        x, dy = (torch.randn(B * H, S, P, generator=gen, device=dev)
                 for _ in range(2))
        b, c = (torch.randn(B, S, N, generator=gen, device=dev)
                for _ in range(2))
        deepest = torch.cumsum(a.reshape(B * H, S // L, L), -1).min().item()
        y = sc.ssd_intra_fwd(a, x, b, c, L)
        grads = sc.ssd_intra_bwd(a, x, b, c, dy, L)
        again = sc.ssd_intra_bwd(a, x, b, c, dy, L)
        torch.cuda.synchronize()
        tag = (f"B={B} H={H} S={S} P={P} N={N} L={L} (deepest in-chunk "
               f"cumsum {deepest:.1f})")
        check(all(bool(torch.isfinite(t).all()) for t in (y, *grads)),
              f"ssd {tag}: finite outputs")
        check(all(torch.equal(u, v) for u, v in zip(grads, again)),
              f"ssd_intra_bwd {tag}: deterministic")
        hold(rows["ssd_intra_fwd"], f"ssd_intra_fwd {tag}", "fwd",
             (("y", y, sc.ssd_intra_fwd_ref(a, x, b, c, L)),))
        hold(rows["ssd_intra_bwd"], f"ssd_intra_bwd {tag}", "bwd",
             tuple(zip(("dx", "db", "dc", "da"), grads,
                       sc.ssd_intra_bwd_ref(a, x, b, c, dy, L))))
        del again
        if not timed:
            continue
        b_fwd, b_bwd = ssd_bound(B, H, S, P, N, L, bw, tf32, products=3)
        simt = dict(zip(("fwd", "bwd"), ssd_bound(B, H, S, P, N, L, bw,
                                                  f32)))
        t = {"fwd": timing.cuda_time_ms(
                 lambda: sc.ssd_intra_fwd(a, x, b, c, L), reps=20),
             "fwd_plain": timing.cuda_time_ms(
                 lambda: sc.ssd_intra_fwd_ref(a, x, b, c, L), reps=5),
             "bwd": timing.cuda_time_ms(
                 lambda: sc.ssd_intra_bwd(a, x, b, c, dy, L), reps=20),
             "bwd_plain": timing.cuda_time_ms(
                 lambda: sc.ssd_intra_bwd_ref(a, x, b, c, dy, L), reps=5)}
        for name, kind, fn in (
                ("ssd_intra_fwd", "fwd",
                 lambda: sc.ssd_intra_fwd(a, x, b, c, L)),
                ("ssd_intra_bwd", "bwd",
                 lambda: sc.ssd_intra_bwd(a, x, b, c, dy, L))):
            print(f"{name} {tag}: by kernel "
                  f"{kernel_times(torch, fn, t[kind])}", flush=True)
        for name, kind, (b_ms, by) in (("ssd_intra_fwd", "fwd", b_fwd),
                                       ("ssd_intra_bwd", "bwd", b_bwd)):
            rows[name].update({"ms": t[kind], "plain_ms": t[kind + "_plain"],
                               "bound_ms": b_ms, "bound_by": by,
                               "library_ms": None,
                               "shape": f"B={B} H={H} S={S} P={P} N={N} "
                                        f"L={L} f32"})
            rows[name]["bound_ms_f32_cuda_cores"] = simt[kind][0]
            print(f"{name} {tag}: kernel {t[kind]:.4f} ms, plain "
                  f"{t[kind + '_plain']:.4f} ms, bound {b_ms:.4f} ms ({by}, "
                  f"3xTF32; {b_ms / t[kind]:.1%}), CUDA-core f32 bound "
                  f"{simt[kind][0]:.4f} ms ({simt[kind][1]}); no single "
                  f"PyTorch call computes it", flush=True)
    for name in rows:
        rows[name]["replaces"] = "src/repro/kernels/ssd_chunk.py:42"
    return rows


# ---------------------------------------------------------------------------
# the asynchronous slice: Original, Async, Async-momentum and Hogwild on the
# PS trainer, the DES, the process transport (phase 16)
# ---------------------------------------------------------------------------

# the disciplines phase 16 holds card against CPU (hogwild_easgd under
# deterministic admission runs the turnstile too)
ASYNC_ALGOS = ("async_sgd", "async_easgd", "async_msgd", "async_measgd",
               "hogwild_easgd", "original_easgd")
NON_SYNC = ("original_easgd", "async_sgd", "async_easgd", "async_msgd",
            "async_measgd", "hogwild_sgd", "hogwild_easgd")
# phase 16's η on AlexNet: async_msgd's master momentum diverges at 0.005
# and 0.002 within 64 iterations in a CPU run of these settings (PERF.md)
ETA_ASYNC_ALEXNET = 0.001


def no_launches(counts: dict) -> dict:
    return {k: 0 for k in counts}


def phase_async_card_vs_cpu(torch, runtime, problems, async_engine, kernels,
                            EASGDConfig, device="cuda") -> dict:
    """(a) The numpy MLP under deterministic admission: each discipline's
    card run equals its CPU run bit for bit (center, workers, counters),
    and the DES on the card equals the card's real run."""
    easgd = EASGDConfig(eta=ETA, rho=RHO, mu=MU)
    totals = {k.__name__: 0 for k in kernels.KERNELS}

    def cfg(algo, p, **kw):
        return runtime.PSConfig(algorithm=algo, n_workers=p, total_iters=48,
                                schedule="round_robin", deterministic=True,
                                eval_every_iters=10**9, **kw)

    for algo in ASYNC_ALGOS:
        for p in (3, 4):
            kernels.reset_launch_counts()
            gpu = runtime.run_ps(problems.NUMPY_MLP, easgd, cfg(algo, p),
                                 device=device)
            counts = kernels.launch_counts()
            cpu = runtime.run_ps(problems.NUMPY_MLP, easgd, cfg(algo, p),
                                 device="cpu")
            check(torch.equal(gpu.center.cpu(), cpu.center)
                  and torch.equal(gpu.workers.cpu(), cpu.workers)
                  and gpu.counters == cpu.counters
                  and gpu.total_iters == cpu.total_iters == 48,
                  f"{algo} P={p} numpy MLP: card == CPU")
            check(counts == no_launches(counts), f"{algo} launched {counts}")
        print(f"{algo} numpy MLP deterministic P=3, 4: card == CPU, bitwise "
              f"(center, workers, counters {cpu.counters})", flush=True)
    for algo, p in (("async_easgd", 4), ("async_measgd", 3),
                    ("original_easgd", 3), ("sync_easgd", 4)):
        w0, grad_fn, eval_fn = problems.NUMPY_MLP.build(device)
        des = async_engine.PSEngine(
            grad_fn, eval_fn, w0, easgd,
            async_engine.SimConfig(n_workers=p, compute_jitter=0.0, seed=0,
                                   schedule="round_robin")
        ).run(algo, total_iters=48)
        kernels.reset_launch_counts()
        real = runtime.run_ps(problems.NUMPY_MLP, easgd, cfg(algo, p),
                              device=device)
        counts = kernels.launch_counts()
        want = no_launches(counts)
        if algo == "sync_easgd":           # every worker, every round
            want["fused_sync_easgd_update"] = 48
        check(counts == want, f"{algo} launched {counts}, expected {want}")
        add_counts(totals, counts)
        check(des.center.device == real.center.device
              and torch.equal(des.center, real.center)
              and torch.equal(des.workers, real.workers)
              and des.total_iters == real.total_iters,
              f"{algo} P={p}: DES == real run on the card")
        print(f"{algo} P={p} round_robin: DES on the card == the card's real "
              f"run, bitwise (DES clock {des.total_time_s:.6f} s, real "
              f"{real.total_time_s:.6f} s)", flush=True)
    return totals


def phase_async_alexnet(torch, runtime, zoo, kernels, EASGDConfig,
                        device="cuda") -> None:
    """(b) Full-width AlexNet, P = 4, thread transport, 64 iterations, each
    non-sync discipline for real (FCFS, lock-free, turnstile); then
    ``run_vs_des`` for async_easgd and hogwild_easgd."""
    p, iters = 4, 64
    easgd = EASGDConfig(eta=ETA_ASYNC_ALEXNET, rho=0.01, mu=MU)
    problem = zoo.resolve("alexnet")
    for algo in NON_SYNC:
        cfg = runtime.PSConfig(algorithm=algo, n_workers=p, total_iters=iters,
                               eval_every_iters=10**9)
        kernels.reset_launch_counts()
        res = runtime.run_ps(problem, easgd, cfg, device=device)
        counts = kernels.launch_counts()
        n = res.center.numel()
        check(n == N_ALEXNET and bool(torch.isfinite(res.center).all())
              and bool(torch.isfinite(res.workers).all())
              and math.isfinite(res.final_metric), f"{algo} finite result")
        # one exchange per iteration at τ = 1: two messages of the row
        check(res.total_iters == iters
              and res.counters == {"sync_rounds": 0, "messages": 2 * iters,
                                   "wire_bytes": 2 * iters * n * 8},
              f"{algo} counted {res.total_iters} iters, {res.counters}")
        # the CNN and the absorb launch no kernel of the port
        check(counts == no_launches(counts), f"{algo} launched {counts}")
        us = 1e6 * res.total_time_s / res.total_iters
        print(f"main path {algo} alexnet n={n} P={p} eta="
              f"{ETA_ASYNC_ALEXNET}: {res.total_iters} iters in "
              f"{res.total_time_s:.3f} s = {us:.1f} us/iter, final err "
              f"{res.final_metric:.4f}, counters {res.counters}", flush=True)
    base = runtime.PSConfig(algorithm="async_easgd", n_workers=p,
                            total_iters=iters, eval_every_iters=10**9)
    cal = runtime.calibrate(problem, base, device=device)
    print(f"calibration alexnet P={p}: gradient alone "
          f"{1e3 * cal.t_grad_serial:.3f} ms, with {p} threads "
          f"{1e3 * cal.t_grad_concurrent:.3f} ms per gradient; axpy "
          f"{1e3 * cal.t_axpy:.4f} ms, alpha {1e6 * cal.alpha:.2f} us",
          flush=True)
    for algo in ("async_easgd", "hogwild_easgd"):
        res, des, rec = runtime.run_vs_des(
            problem, easgd, dataclasses.replace(base, algorithm=algo),
            cal=cal, device=device)
        check(math.isfinite(rec["measured_over_des"])
              and des.total_iters == res.total_iters == iters,
              f"{algo} run_vs_des")
        print(f"run_vs_des {algo} alexnet P={p}: measured "
              f"{rec['measured_us_per_iter']:.1f} us/iter, DES "
              f"{rec['des_us_per_iter']:.1f} us/iter, measured_over_des "
              f"{rec['measured_over_des']:.3f}", flush=True)


def phase_async_lm(torch, runtime, zoo, kernels, configs, EASGDConfig,
                   device="cuda") -> dict:
    """(c) The reduced LMs on the new disciplines, counters 0 before each
    run and read after: every worker warms up on 2 gradients; Original
    EASGD and Hogwild then compute exactly the quota, the async family
    under the turnstile one gradient more per worker (computed ahead of a
    turn that never comes); one final eval."""
    p, iters = 4, 32
    easgd = EASGDConfig(eta=0.05, rho=0.05, mu=MU)
    totals = {k.__name__: 0 for k in kernels.KERNELS}
    for arch, algo, det in (("gemma3-4b", "original_easgd", False),
                            ("gemma3-4b", "hogwild_easgd", False),
                            ("mamba2-780m", "async_measgd", True)):
        cfg = configs.get(arch).reduced
        ps_cfg = runtime.PSConfig(algorithm=algo, n_workers=p,
                                  total_iters=iters, deterministic=det,
                                  eval_every_iters=10**9)
        kernels.reset_launch_counts()
        res = runtime.run_ps(zoo.resolve(arch), easgd, ps_cfg, device=device)
        counts = kernels.launch_counts()
        ahead = p if det and algo != "original_easgd" else 0
        want = lm_counts(cfg, 2 * p + iters + ahead, evals=1)
        check(counts == want, f"{algo} on {arch} launched {counts}, "
              f"expected {want}")
        check(bool(torch.isfinite(res.center).all())
              and math.isfinite(res.final_metric)
              and res.total_iters == iters
              and res.counters["messages"] == 2 * iters,
              f"{algo} on {arch}: finite and counted")
        add_counts(totals, counts)
        us = 1e6 * res.total_time_s / res.total_iters
        print(f"main path {algo} {arch} reduced n={res.center.numel()} P={p}"
              f"{' deterministic' if det else ''}: {res.total_iters} iters "
              f"in {res.total_time_s:.3f} s = {us:.1f} us/iter, final eval "
              f"loss {res.final_metric:.4f}, counters {res.counters}, "
              f"launches {counts}", flush=True)
    return totals


def phase_process(torch, runtime, problems, zoo, kernels, EASGDConfig,
                  device="cuda") -> dict:
    """(d) The process transport on the card: spawned workers, the tensors
    shared by CUDA IPC, each worker's launch counts folded into the
    launcher's. Deterministic async_easgd and sync_easgd equal their thread
    runs bit for bit; one FCFS run on AlexNet."""
    easgd = EASGDConfig(eta=ETA, rho=RHO, mu=MU)
    totals = {k.__name__: 0 for k in kernels.KERNELS}
    for algo, det in (("async_easgd", True), ("sync_easgd", False)):
        runs = []
        for tr in ("process", "thread"):
            cfg = runtime.PSConfig(algorithm=algo, n_workers=2,
                                   total_iters=48, transport=tr,
                                   schedule="ring", deterministic=det,
                                   eval_every_iters=10**9)
            kernels.reset_launch_counts()
            t = time.perf_counter()
            res = runtime.run_ps(problems.NUMPY_MLP, easgd, cfg,
                                 device=device)
            runs.append((res, kernels.launch_counts(),
                         time.perf_counter() - t))
        (proc, c_proc, wall), (thr, c_thr, _) = runs
        want = no_launches(c_proc)
        if algo == "sync_easgd":           # 2 workers × 24 rounds
            want["fused_sync_easgd_update"] = 48
        check(c_proc == c_thr == want, f"{algo} launched {c_proc} in "
              f"processes, {c_thr} in threads, expected {want}")
        check(torch.equal(proc.center, thr.center)
              and torch.equal(proc.workers, thr.workers)
              and proc.counters == thr.counters
              and proc.total_iters == thr.total_iters == 48,
              f"{algo}: process == thread")
        add_counts(totals, c_proc)
        print(f"process transport {algo} numpy MLP P=2: == thread run, "
              f"bitwise (center, workers, counters {proc.counters}); "
              f"launches across processes {c_proc}; {wall:.1f} s with "
              f"spawn", flush=True)
    cfg = runtime.PSConfig(algorithm="async_easgd", n_workers=2,
                           total_iters=32, transport="process",
                           eval_every_iters=10**9)
    kernels.reset_launch_counts()
    res = runtime.run_ps(zoo.resolve("alexnet"),
                         EASGDConfig(eta=ETA_ASYNC_ALEXNET, rho=0.01, mu=MU),
                         cfg, device=device)
    counts = kernels.launch_counts()
    n = res.center.numel()
    check(bool(torch.isfinite(res.center).all())
          and bool(torch.isfinite(res.workers).all())
          and res.total_iters == 32
          and res.counters == {"sync_rounds": 0, "messages": 64,
                               "wire_bytes": 64 * n * 8}
          and counts == no_launches(counts),
          f"process FCFS alexnet: {res.counters}, launches {counts}")
    print(f"process transport async_easgd alexnet n={n} P=2 FCFS: "
          f"{res.total_iters} iters in {res.total_time_s:.3f} s = "
          f"{1e6 * res.total_time_s / res.total_iters:.1f} us/iter, final "
          f"err {res.final_metric:.4f}, counters {res.counters}", flush=True)
    return totals


def phase_ps_launcher(launcher, kernels, device="cuda") -> dict:
    """(e) ``launch.train --mode ps --algorithm all`` on tiny-mlp on the
    card: nine result lines with finite errors and the DES columns. The
    launcher sets the counts to 0 before each algorithm; after it returns
    they hold the last one's, sync_easgd: its update once per worker and
    round (the DES launches nothing)."""
    p, iters = 2, 80
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        results = launcher.main(["--mode", "ps", "--algorithm", "all",
                                 "--ps-workers", str(p), "--ps-iters",
                                 str(iters), "--device", device])
    text = out.getvalue()
    print(text, end="", flush=True)
    lines = [ln for ln in text.splitlines() if "ratio=" in ln]
    check(len(results) == 9 and len(lines) == 9, "nine launcher lines")
    for line in lines:
        err = float(line.split(" err=")[1].split()[0])
        ratio = float(line.split(" ratio=")[1].split()[0])
        check("des=" in line and f"@{device}" in line and math.isfinite(err)
              and math.isfinite(ratio) and ratio > 0, f"line {line!r}")
    counts = kernels.launch_counts()
    want = no_launches(counts)
    want["fused_sync_easgd_update"] = iters
    check(results[-1].algorithm == "sync_easgd" and counts == want,
          f"launcher's sync_easgd launched {counts}, expected {want}")
    return counts


# ---------------------------------------------------------------------------
# the tcp slice (phase 17): the wire, the p2p plane and span tracing
# ---------------------------------------------------------------------------

def only(counts: dict, **want) -> dict:
    """``counts`` with every kernel 0 but ``want``."""
    out = no_launches(counts)
    out.update(want)
    return out


def phase_tcp_bitwise(torch, runtime, problems, kernels, EASGDConfig,
                      device="cuda") -> dict:
    """(17a) The numpy MLP under deterministic admission: the card's tcp
    run equals the card's thread run and the CPU's thread run bit for bit
    (72 iterations, round_robin); then the thread ↔ master ↔ p2p triangle
    on the card. The fused updates launch in the master (master plane) or
    in the worker processes (p2p), counted exactly either way."""
    easgd = EASGDConfig(eta=ETA, rho=RHO, mu=MU)
    totals = {k.__name__: 0 for k in kernels.KERNELS}

    def run(algo, p, iters, schedule, dev, **kw):
        cfg = runtime.PSConfig(algorithm=algo, n_workers=p,
                               total_iters=iters, schedule=schedule,
                               deterministic=True, eval_every_iters=10**9,
                               **kw)
        kernels.reset_launch_counts()
        res = runtime.run_ps(problems.NUMPY_MLP, easgd, cfg, device=dev)
        return res, kernels.launch_counts()

    def same(a, b):
        return (torch.equal(a.center.cpu(), b.center.cpu())
                and torch.equal(a.workers.cpu(), b.workers.cpu())
                and a.total_iters == b.total_iters)

    for algo, p in (("sync_easgd", 2), ("sync_easgd", 3), ("sync_sgd", 4),
                    ("async_easgd", 2)):
        tcp, c_tcp = run(algo, p, 72, "round_robin", device,
                         transport="tcp")
        thr, c_thr = run(algo, p, 72, "round_robin", device)
        cpu, _ = run(algo, p, 72, "round_robin", "cpu")
        want = {"sync_easgd": only(c_tcp, fused_sync_easgd_update=72),
                "sync_sgd": only(c_tcp, fused_sync_sgd_update=72 // p),
                "async_easgd": only(c_tcp)}[algo]
        check(c_tcp == c_thr == want, f"{algo} P={p} launched {c_tcp} over "
              f"tcp, {c_thr} in threads, expected {want}")
        check(same(tcp, thr) and same(thr, cpu) and tcp.total_iters == 72,
              f"{algo} P={p}: card tcp == card thread == CPU thread")
        add_counts(totals, c_tcp)
        print(f"tcp {algo} numpy MLP P={p} deterministic: card tcp == card "
              f"thread == CPU thread, bitwise; launches {want}; worker "
              f"spawn to READY {tcp.counters['worker_ready_s']} s, start-up "
              f"{tcp.counters['worker_startup_s']}", flush=True)
    for algo, p, schedule in (("sync_easgd", 2, "tree"),
                              ("sync_easgd", 3, "ring"),
                              ("sync_sgd", 4, "butterfly")):
        thr, c_thr = run(algo, p, 48, schedule, device)
        mst, c_mst = run(algo, p, 48, schedule, device, transport="tcp")
        p2p, c_p2p = run(algo, p, 48, schedule, device, transport="tcp",
                         sync_plane="p2p")
        upd = {"sync_easgd": "fused_sync_easgd_update",
               "sync_sgd": "fused_sync_sgd_update"}[algo]
        central = 48 if algo == "sync_easgd" else 48 // p
        check(c_thr == c_mst == only(c_thr, **{upd: central})
              and c_p2p == only(c_p2p, **{upd: 48}),
              f"{algo} {schedule}: launches thread {c_thr}, master {c_mst}, "
              f"p2p {c_p2p}")
        check(same(thr, mst) and same(thr, p2p)
              and p2p.schedule == f"{schedule}+p2p",
              f"{algo} P={p} {schedule}: thread == master == p2p")
        add_counts(totals, c_mst)
        add_counts(totals, c_p2p)
        print(f"triangle {algo} P={p} {schedule}: thread == tcp master == "
              f"tcp p2p on the card, bitwise; {upd} launches master "
              f"{c_mst[upd]} (in the master), p2p {c_p2p[upd]} (in the "
              f"{p} workers); master_link_bytes master "
              f"{mst.counters['master_link_bytes']} vs p2p "
              f"{p2p.counters['master_link_bytes']}", flush=True)
    return totals


def shares(res) -> str:
    rep = res.trace["report"]
    return (f"compute {rep['mean_compute_share']:.4f} exposed comm "
            f"{rep['mean_comm_share']:.4f} update "
            f"{rep['mean_update_share']:.4f}")


def phase_tcp_alexnet(torch, runtime, zoo, kernels, comm_rounds, wire,
                      EASGDConfig, device="cuda", notes=None) -> dict:
    """(17b) Full-width AlexNet, P = 4, ring, 4 MiB buckets, 16 rounds,
    Sync EASGD five ways: thread, tcp master plane, tcp p2p with overlap on
    and off, tcp p2p with sign_ef. Each untraced (µs/iter) and traced
    (the Table-3 shares); the bytes on the master's links, on each peer
    link and in all; kernel 1's launches, exact; the loopback α–β."""
    p, rounds = 4, 16
    easgd = EASGDConfig(eta=0.005, rho=0.01, mu=MU)
    problem = zoo.resolve("alexnet")
    alpha, beta = wire.measure_link()
    print(f"loopback link (wire.measure_link): alpha {1e6 * alpha:.2f} us, "
          f"beta {1e9 * beta:.4f} ns/B = {1e-9 / beta:.3f} GB/s", flush=True)
    _, grad_fn, _ = problem.build(device)
    n_pad = N_ALEXNET + (-N_ALEXNET) % p
    cuts = comm_rounds.default_bucket_boundaries(grad_fn.layer_sizes, n_pad,
                                                 4 << 20)
    live = sum(a < N_ALEXNET for a in cuts[:-1])   # buckets holding weights
    ways = (("thread", {}),
            ("tcp master", {"transport": "tcp"}),
            ("tcp p2p overlap", {"transport": "tcp", "sync_plane": "p2p"}),
            ("tcp p2p no overlap", {"transport": "tcp", "sync_plane": "p2p",
                                    "overlap": False}),
            ("tcp p2p sign_ef", {"transport": "tcp", "sync_plane": "p2p",
                                 "wire_compression": "sign_ef"}))
    totals = {k.__name__: 0 for k in kernels.KERNELS}
    results = {}
    for name, kw in ways:
        p2p = kw.get("sync_plane") == "p2p"
        want = p * rounds * (live if p2p else 1)
        det = kw.get("wire_compression", "none") == "none"
        for trace in (False, True):
            cfg = runtime.PSConfig(algorithm="sync_easgd", n_workers=p,
                                   total_iters=p * rounds, schedule="ring",
                                   eval_every_iters=10**9,
                                   bucket_bytes=4 << 20, deterministic=det,
                                   trace=trace, **kw)
            kernels.reset_launch_counts()
            res = runtime.run_ps(problem, easgd, cfg, device=device)
            counts = kernels.launch_counts()
            check(counts == only(counts, fused_sync_easgd_update=want),
                  f"{name} alexnet launched {counts}, expected {want}")
            check(res.center.numel() == N_ALEXNET
                  and bool(torch.isfinite(res.center).all())
                  and bool(torch.isfinite(res.workers).all())
                  and math.isfinite(res.final_metric)
                  and res.total_iters == p * rounds, f"{name} finite")
            add_counts(totals, counts)
            results[name, trace] = res
        plain, traced = results[name, False], results[name, True]
        c = plain.counters
        us = [1e6 * r.total_time_s / (p * rounds) for r in (plain, traced)]
        if notes is not None:
            notes[name] = us[0]
        print(f"tcp-slice alexnet sync_easgd {name} P={p} ring 4MiB "
              f"buckets, {rounds} rounds: {us[0]:.1f} us/iter untraced, "
              f"{us[1]:.1f} us/iter traced; Table-3 shares (traced) "
              f"{shares(traced)}; master_link_bytes "
              f"{c.get('master_link_bytes', 0)}, peer_link_bytes "
              f"{c.get('peer_link_bytes', {})}, peer_wire_bytes "
              f"{c.get('peer_wire_bytes', 0)}, wire_bytes {c['wire_bytes']}; "
              f"comm_s {c.get('comm_s', 0):.4f} exposed_s "
              f"{c.get('exposed_s', 0):.4f}; fused_sync_easgd_update "
              f"launches {want}"
              + (f" ({live} live buckets x {p} workers x {rounds} rounds)"
                 if p2p else "")
              + (f"; worker spawn to READY {c['worker_ready_s']} s"
                 if "worker_ready_s" in c else ""), flush=True)
    ref = results["thread", False]
    for name in ("tcp master", "tcp p2p overlap", "tcp p2p no overlap"):
        res = results[name, False]
        same = (torch.equal(res.center, ref.center)
                and torch.equal(res.workers, ref.workers))
        print(f"tcp-slice alexnet {name} == thread run bit for bit: {same}",
              flush=True)
    none = results["tcp p2p overlap", False].counters["peer_wire_bytes"]
    sign = results["tcp p2p sign_ef", False].counters["peer_wire_bytes"]
    print(f"tcp-slice alexnet sign_ef cuts peer_wire_bytes {none / sign:.2f}x",
          flush=True)
    return totals


def phase_trace_cost(torch, runtime, zoo, kernels, EASGDConfig,
                     device="cuda") -> dict:
    """(17c) What tracing costs: AlexNet Sync EASGD on the thread plane
    (phase 5's setting), untraced and traced in turns, µs/iter of each
    and the traced run's shares."""
    p, rounds = 4, 16
    easgd = EASGDConfig(eta=0.005, rho=0.01, mu=MU)
    problem = zoo.resolve("alexnet")
    us = {False: [], True: []}
    totals = {k.__name__: 0 for k in kernels.KERNELS}
    last = None
    for trace in (False, True, True, False):
        cfg = runtime.PSConfig(algorithm="sync_easgd", n_workers=p,
                               total_iters=p * rounds, schedule="ring",
                               eval_every_iters=10**9, bucket_bytes=4 << 20,
                               trace=trace)
        kernels.reset_launch_counts()
        res = runtime.run_ps(problem, easgd, cfg, device=device)
        counts = kernels.launch_counts()
        check(counts == only(counts, fused_sync_easgd_update=p * rounds)
              and (res.trace is not None) == trace,
              f"trace={trace} launched {counts}")
        add_counts(totals, counts)
        us[trace].append(round(1e6 * res.total_time_s / res.total_iters, 1))
        if trace:
            last = res
    print(f"trace cost alexnet sync_easgd thread P={p}: untraced "
          f"{us[False]} us/iter, traced {us[True]} us/iter (runs in the "
          f"order off, on, on, off); traced shares {shares(last)}; "
          f"per worker {last.trace['report']['workers']}", flush=True)
    return totals


def phase_tcp_entry_points(device="cuda") -> None:
    """(17d) The entry points as subprocesses on the card: ``launch.train
    --transport tcp --sync-plane p2p --trace`` and ``launch.cluster``."""
    out_dir = Path(__file__).resolve().parent / "build" / "tcp_trace"
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC)
    cmds = (["-m", "repro_torch.launch.train", "--mode", "ps",
             "--algorithm", "sync_easgd", "--transport", "tcp",
             "--sync-plane", "p2p", "--trace", "--trace-dir", str(out_dir),
             "--ps-workers", "2", "--ps-iters", "40", "--emulate", "none",
             "--device", device],
            ["-m", "repro_torch.launch.cluster", "--workers", "2",
             "--algorithm", "sync_easgd", "--iters", "40", "--device",
             device])
    for args in cmds:
        t = time.perf_counter()
        proc = subprocess.run([sys.executable, *args], env=env,
                              capture_output=True, text=True, timeout=600)
        lines = [ln for ln in proc.stdout.splitlines() if " err=" in ln]
        check(proc.returncode == 0 and bool(lines), f"{args[1]} exited "
              f"{proc.returncode}: {proc.stderr[-2000:]}")
        for line in lines:
            err = float(line.split(" err=")[1].split()[0])
            check(math.isfinite(err) and "[tcp/ring" in line
                  and f"@{device}" in line, f"line {line!r}")
            print(f"{args[1]}: {line[:400]}", flush=True)
        for line in proc.stdout.splitlines():
            if " trace: " in line:
                print(f"{args[1]}: {line}", flush=True)
        print(f"{args[1]} as a subprocess on the card: exit 0 in "
              f"{time.perf_counter() - t:.1f} s", flush=True)


def phase_tcp_lm(torch, runtime, zoo, kernels, configs, EASGDConfig,
                 device="cuda") -> dict:
    """(17e) Reduced gemma3-4b over tcp p2p, P = 2, 16 rounds: attention
    and cross-entropy launch inside the worker processes (2 warm-up
    gradients each, then one a round) and in the master (the final eval);
    the update once per worker and round."""
    p, rounds = 2, 16
    cfg = configs.get("gemma3-4b").reduced
    ps_cfg = runtime.PSConfig(algorithm="sync_easgd", n_workers=p,
                              total_iters=p * rounds, schedule="ring",
                              transport="tcp", sync_plane="p2p",
                              eval_every_iters=10**9)
    kernels.reset_launch_counts()
    res = runtime.run_ps(zoo.resolve("gemma3-4b"),
                         EASGDConfig(eta=0.05, rho=0.05, mu=MU), ps_cfg,
                         device=device)
    counts = kernels.launch_counts()
    want = lm_counts(cfg, 2 * p + p * rounds, evals=1)
    want["fused_sync_easgd_update"] = p * rounds
    check(counts == want, f"gemma3-4b tcp p2p launched {counts}, expected "
          f"{want}")
    check(bool(torch.isfinite(res.center).all())
          and math.isfinite(res.final_metric)
          and res.total_iters == p * rounds, "gemma3-4b tcp p2p finite")
    print(f"tcp p2p gemma3-4b reduced n={res.center.numel()} P={p} ring "
          f"{rounds} rounds: {1e6 * res.total_time_s / res.total_iters:.1f} "
          f"us/iter, final eval loss {res.final_metric:.4f}, launches "
          f"{counts} (the workers' counts from BYE), worker start-up "
          f"{res.counters['worker_startup_s']}", flush=True)
    return counts


# ---------------------------------------------------------------------------
# phase 18: the live telemetry plane and elastic membership over tcp
# ---------------------------------------------------------------------------

PHASE18_DIR = Path(__file__).resolve().parent / "build" / "phase18"


def release_card(torch, what: str) -> None:
    """Hand this process's cached device blocks back to the card before a
    phase whose worker processes allocate on it (the full-width LM phases
    leave tens of GiB reserved in this process's caching allocator), and
    print the room the workers get."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"{what}: {free / 2**30:.2f} of {total / 2**30:.2f} GiB free on "
          f"the card, {torch.cuda.memory_reserved() / 2**30:.2f} GiB still "
          f"reserved by this process", flush=True)


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def same_run(torch, a, b) -> bool:
    return (torch.equal(a.center.cpu(), b.center.cpu())
            and torch.equal(a.workers.cpu(), b.workers.cpu())
            and a.total_iters == b.total_iters)


def phase_elastic_bitwise(torch, runtime, problems, kernels, costmodel,
                          EASGDConfig, device="cuda") -> dict:
    """(18a) The numpy MLP under deterministic admission: a chaos
    dial-refuse window (sync_easgd, P = 2, 40 iterations) and one link
    paced 3x slower (``link_slow``, async_easgd, P = 3, 36 iterations) over
    tcp on the card equal the card's thread run and the CPU's thread run
    bit for bit, with the update's launches exact."""
    easgd = EASGDConfig(eta=ETA, rho=RHO, mu=MU)
    net = costmodel.Network("tiny-emu", 5e-3, 1e-9)
    totals = {k.__name__: 0 for k in kernels.KERNELS}

    def run(algo, p, iters, dev, **kw):
        cfg = runtime.PSConfig(algorithm=algo, n_workers=p,
                               total_iters=iters, schedule="round_robin",
                               deterministic=True, eval_every_iters=10**9,
                               **kw)
        kernels.reset_launch_counts()
        res = runtime.run_ps(problems.NUMPY_MLP, easgd, cfg, device=dev)
        return res, kernels.launch_counts()

    cases = (("sync_easgd", 2, 40, "dial refused 0.4 s on wid 1",
              {"chaos": {"wid": 1, "dial_refuse_s": 0.4}}),
             ("async_easgd", 3, 36, "link_slow (1, 1, 3)",
              {"emulate_net": net, "link_slow": (1.0, 1.0, 3.0)}))
    for algo, p, iters, what, kw in cases:
        tcp, c_tcp = run(algo, p, iters, device, transport="tcp", **kw)
        thr, c_thr = run(algo, p, iters, device)
        cpu, _ = run(algo, p, iters, "cpu")
        want = (only(c_tcp, fused_sync_easgd_update=iters)
                if algo == "sync_easgd" else only(c_tcp))
        check(c_tcp == c_thr == want, f"{algo} {what}: launched {c_tcp} "
              f"over tcp, {c_thr} in threads, expected {want}")
        check(same_run(torch, tcp, thr) and same_run(torch, thr, cpu),
              f"{algo} P={p} {what}: card tcp == card thread == CPU thread")
        add_counts(totals, c_tcp)
        print(f"elastic-slice {algo} numpy MLP P={p} {what}: card tcp == "
              f"card thread == CPU thread, bitwise; {1e6 * tcp.total_time_s
              / tcp.total_iters:.1f} us/iter over tcp; launches {want}",
              flush=True)
    return totals


def phase_live(torch, runtime, zoo, problems, kernels, costmodel,
               EASGDConfig, notes: dict, device="cuda",
               model="alexnet") -> dict:
    """(18b) The live plane. Full-width AlexNet, P = 4, ring, p2p, 4 MiB
    buckets, 16 rounds, Sync EASGD with telemetry off and on (JSONL
    stream, 0.5 s heartbeats in both, a 0.1 s sampler): µs/iter of each beside phase 17b's
    untraced p2p reading, the health summary, exact launches. Then the
    numpy MLP with hogwild_easgd at P = 3 and wid 2's link paced 8x
    slower: the detector must name wid 2 alone, and ``python -m
    repro_torch.launch.monitor --connect --follow`` (a subprocess started
    with the run) must fetch STATS snapshots mid-run, one with samples in
    it, and exit 0 when the run ends."""
    PHASE18_DIR.mkdir(parents=True, exist_ok=True)
    p, rounds = 4, 16
    easgd = EASGDConfig(eta=0.005, rho=0.01, mu=MU)
    problem = zoo.resolve(model)
    w0, grad_fn, _ = problem.build(device)
    from repro_torch.comm import rounds as comm_rounds
    n = w0.numel()
    n_pad = n + (-n) % p
    cuts = comm_rounds.default_bucket_boundaries(grad_fn.layer_sizes, n_pad,
                                                 4 << 20)
    live_buckets = sum(a < n for a in cuts[:-1])
    want = p * rounds * live_buckets
    totals = {k.__name__: 0 for k in kernels.KERNELS}
    us = {}
    jsonl = str(PHASE18_DIR / "alexnet_telemetry.jsonl")
    for on in (False, True):
        cfg = runtime.PSConfig(
            algorithm="sync_easgd", n_workers=p, total_iters=p * rounds,
            schedule="ring", transport="tcp", sync_plane="p2p",
            bucket_bytes=4 << 20, eval_every_iters=10**9, hb_interval_s=0.5,
            telemetry_jsonl=jsonl if on else None, telemetry_interval_s=0.1)
        kernels.reset_launch_counts()
        res = runtime.run_ps(problem, easgd, cfg, device=device)
        counts = kernels.launch_counts()
        check(counts == only(counts, fused_sync_easgd_update=want),
              f"alexnet p2p telemetry={on} launched {counts}, expected "
              f"{want}")
        check(bool(torch.isfinite(res.center).all())
              and res.total_iters == p * rounds
              and (res.health is not None) == on, f"telemetry={on} run")
        add_counts(totals, counts)
        us[on] = 1e6 * res.total_time_s / res.total_iters
        if on:
            lines = [json.loads(x) for x in open(jsonl)]
            check(lines[0]["meta"]["algorithm"] == "sync_easgd"
                  and res.health["n_samples"] >= 1, "telemetry JSONL")
            print(f"live alexnet p2p telemetry on: {res.health['n_samples']}"
                  f" samples, {len(lines)} JSONL lines, events "
                  f"{res.health['events']}, last per-worker telemetry "
                  f"{res.health['workers']}", flush=True)
    ref = notes.get("tcp p2p overlap")
    print(f"live alexnet sync_easgd tcp p2p P={p} ring 4MiB buckets, "
          f"{rounds} rounds: {us[False]:.1f} us/iter telemetry off, "
          f"{us[True]:.1f} us/iter telemetry on ({us[True] / us[False]:.3f}x)"
          + (f"; phase 17b untraced {ref:.1f} us/iter" if ref else "")
          + f"; fused_sync_easgd_update launches {want} each", flush=True)

    port = free_port()
    net = costmodel.Network("tiny-emu", 5e-3, 1e-9)
    cfg = runtime.PSConfig(algorithm="hogwild_easgd", n_workers=3,
                           total_iters=480, transport="tcp", schedule="ring",
                           eval_every_iters=10**9, emulate_net=net,
                           link_slow=(1.0, 1.0, 8.0), hb_interval_s=0.2,
                           telemetry=True, tcp_port=port)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC)
    mon = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.monitor", "--connect",
         f"127.0.0.1:{port}", "--k", "8", "--retry-for", "120", "--follow",
         "--interval", "0.5"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        kernels.reset_launch_counts()
        res = runtime.run_ps(problems.NUMPY_MLP,
                             EASGDConfig(eta=ETA, rho=RHO, mu=MU), cfg,
                             device=device)
        counts = kernels.launch_counts()
        out, err = mon.communicate(timeout=120)
    finally:
        if mon.poll() is None:
            mon.kill()
            mon.wait()
    check(counts == no_launches(counts), f"hogwild launched {counts}")
    flags = [e for e in res.health["events"] if e["kind"] == "straggler"]
    check(bool(flags) and all(e["wid"] == 2 for e in flags),
          f"straggler named: {res.health['events']}")
    tables = out.split("run: ")[1:]
    samples = [int(t.split("samples=")[1].split()[0]) for t in tables]
    check(mon.returncode == 0 and "rate history" in out
          and max(samples, default=0) > 0,
          f"launch.monitor --connect exited {mon.returncode}, samples "
          f"{samples}: {err[-2000:]}")
    print(f"live straggler hogwild_easgd numpy MLP P=3 link_slow (1, 1, 8) "
          f"on the card: first flag {flags[0]}; health_events "
          f"{res.counters['health_events']}; "
          f"{1e6 * res.total_time_s / res.total_iters:.1f} us/iter",
          flush=True)
    best = max(range(len(tables)), key=samples.__getitem__)
    print(f"live launch.monitor --connect --follow: {len(tables)} STATS "
          f"snapshots mid-run, exit 0; the one with most samples:")
    for line in ("run: " + tables[best]).splitlines()[:8]:
        print(f"  | {line}")
    return totals


def resume_rounds(res) -> dict:
    """{epoch: the master's agreed resume round} from the p2p reconfigure
    events."""
    out = {}
    for e in res.health["events"]:
        if e["kind"] == "reconfigure" and "resume_round=" in e["detail"]:
            epoch = int(e["detail"].split(":")[0].split()[1])
            out[epoch] = int(e["detail"].split("resume_round=")[1])
    return out


def epoch_report(res, counts, n_rounds: int, upd: str,
                 killed: int = 1) -> tuple:
    """Check the elastic run's update launches and rounds against the
    workers' epoch logs (BYE) and the master's resume rounds, and return
    (per-epoch lines, µs/iter per epoch). Each final member's epochs must
    chain: every epoch after the first starts at the master's resume
    round, and the rounds kept (up to the next resume round) add up to the
    run's ``n_rounds``; ``killed`` workers of epoch 0 send no log. Each round run made one launch a live bucket; only the
    round a fault interrupted may add fewer than a round's launches, and
    the launch counter must equal the logged launches."""
    logs = res.counters["worker_epochs"]
    total = sum(e["updates"] for log in logs.values() for e in log)
    check(counts[upd] == total, f"{upd} launches {counts[upd]} == the "
          f"workers' logged updates {total}")
    resumes = resume_rounds(res)
    by_epoch: dict = {}
    for wid, log in logs.items():
        kept_all = 0
        for i, e in enumerate(log):
            lb = e["live_buckets"]
            last = i == len(log) - 1
            check(e["epoch"] == 0 or e["start"] == resumes.get(e["epoch"]),
                  f"wid {wid} epoch {e['epoch']} starts at {e['start']}, "
                  f"the master's resume round {resumes.get(e['epoch'])}")
            check(e["rounds"] == e["end"] - e["start"],
                  f"wid {wid} epoch {e['epoch']} rounds")
            extra = e["updates"] - e["rounds"] * lb
            check(extra == 0 if last else 0 <= extra < lb,
                  f"wid {wid} epoch {e['epoch']}: {e['updates']} updates "
                  f"for {e['rounds']} rounds x {lb} buckets")
            kept = (e["end"] if last else e["resume_next"]) - e["start"]
            check(0 <= e["rounds"] - kept <= 1, f"wid {wid} rollback")
            kept_all += kept
            d = by_epoch.setdefault(e["epoch"], {
                "p": e["p"], "kept": kept, "lb": lb, "workers": 0,
                "launches": 0, "us": None})
            check((d["p"], d["kept"], d["lb"]) == (e["p"], kept, lb),
                  f"epoch {e['epoch']} agrees across workers")
            d["workers"] += 1
            d["launches"] += e["updates"]
            if wid == min(logs) and e["rounds"]:
                d["us"] = 1e6 * (e["t1"] - e["t0"]) / (e["rounds"] * e["p"])
        if log[-1]["epoch"] == res.health["epoch"]:
            check(log[0]["start"] + kept_all == n_rounds,
                  f"wid {wid}: rounds kept {kept_all} from round "
                  f"{log[0]['start']} reach {n_rounds}")
    lines, us = [], {}
    for ep, d in sorted(by_epoch.items()):
        want = d["p"] - (killed if ep == 0 else 0)
        check(d["workers"] == want, f"epoch {ep}: {d['workers']} logs for "
              f"p={d['p']}, expected {want}")
        kept_launches = d["workers"] * d["kept"] * d["lb"]
        us[ep] = d["us"]
        lines.append(f"epoch {ep} p={d['p']}: {d['kept']} rounds kept x "
                     f"{d['workers']} workers x {d['lb']} live buckets = "
                     f"{kept_launches} update launches kept, "
                     f"{d['launches'] - kept_launches} rolled back or cut "
                     f"short; {d['us']:.1f} us/iter" if d["us"] is not None
                     else f"epoch {ep} p={d['p']}: no rounds")
    return lines, us


def run_with_respawn(runtime, server, kernels, problem, easgd, cfg, jsonl,
                     device):
    """Run ``cfg`` (elastic; chaos kills wid 2) while ``server.Respawner``
    respawns wid 2 — ``python -m repro_torch.net.worker --rejoin`` from its
    ``REPRO_CLUSTER_SPEC`` — the moment the reconfigure event reaches the
    ``jsonl`` stream. Returns (PSResult, the run's launch counts, the
    respawn's monotonic start); the rejoiner must exit 0."""
    if jsonl.exists():
        jsonl.unlink()
    with server.Respawner(jsonl, 2, device,
                          n_workers=cfg.n_workers) as spare:
        kernels.reset_launch_counts()
        res = runtime.run_ps(problem, easgd, cfg, device=device)
        counts = kernels.launch_counts()
    code, out = spare.finish(timeout_s=60.0)
    check(bool(spare.spawned), "the reconfigure event reached the JSONL "
          "stream")
    check(code == 0, f"rejoiner exited {code}: {out[-2000:]}")
    kinds = [e["kind"] for e in res.health["events"]]
    check(res.health["epoch"] == 2 and kinds.count("reconfigure") == 2
          and res.health["membership"]["members"]
          == {0: "active", 1: "active", 2: "active", 3: "active"},
          f"epoch 2 with every member active: {res.health}")
    return res, counts, spare.spawned[0][0]


def phase_elastic(torch, runtime, zoo, problems, kernels, comm_rounds, eu,
                  server, costmodel, EASGDConfig, device="cuda",
                  model="alexnet", rounds=200) -> dict:
    """(18c) Elastic membership at full width: AlexNet, P = 4, ring, p2p,
    4 MiB buckets, Sync EASGD, ``elastic=True``, wid 2 SIGKILLed by chaos;
    a respawn started when the reconfigure event reaches the JSONL stream
    rejoins, and the run must reach epoch 2 with all four members active.
    It prints the time to recover (death seen by the master → the first
    post-reconfigure round done by every survivor), the rejoin time
    (respawn → worker_rejoined, with the rejoiner's import and card time),
    µs/iter per epoch, and the update's launches against the workers'
    epoch logs (P = 4, 3, 4). One post-shrink bucket update at P = 3 is
    held bit for bit against the plain version. Then on the numpy MLP: a
    p2p SIGKILL shrink and a SIGTERM departure, each bit for bit the CPU's
    run with that worker SIGKILLed at the card run's resume round; a p2p sync_sgd kill and respawn on a paced wire (the velocity
    relayed with the center: every replica ends on the center); master-
    plane sync_easgd and sync_sgd kills (the plan rebuilt for P′ = 2, the
    launches as the served rosters give them); and a kill with elastic
    off, which must fail."""
    PHASE18_DIR.mkdir(parents=True, exist_ok=True)
    p, kill_at = 4, 8
    easgd = EASGDConfig(eta=0.005, rho=0.01, mu=MU)
    problem = zoo.resolve(model)
    jsonl = PHASE18_DIR / "elastic.jsonl"
    cfg = runtime.PSConfig(
        algorithm="sync_easgd", n_workers=p, total_iters=p * rounds,
        schedule="ring", transport="tcp", sync_plane="p2p",
        bucket_bytes=4 << 20, eval_every_iters=10**9, elastic=True,
        telemetry_jsonl=str(jsonl),
        chaos={"wid": 2, "kill_at_iter": kill_at, "signal": "kill"})
    res, counts_alexnet, t_spawn = run_with_respawn(
        runtime, server, kernels, problem, easgd, cfg, jsonl, device)
    check(bool(torch.isfinite(res.center).all())
          and math.isfinite(res.final_metric), "elastic alexnet finite")
    n_upd = counts_alexnet["fused_sync_easgd_update"]
    check(counts_alexnet == only(counts_alexnet,
                                 fused_sync_easgd_update=n_upd),
          f"elastic alexnet launched {counts_alexnet}")
    lines, us = epoch_report(res, counts_alexnet, rounds,
                             "fused_sync_easgd_update")
    marks = {}
    for kind, wid, mono in res.counters["membership_marks"]:
        marks.setdefault(kind, mono)
    logs = res.counters["worker_epochs"]
    firsts = [log[1]["t_first"] for w, log in logs.items()
              if w != 2 and len(log) > 1 and log[1]["epoch"] == 1]
    recover = max(firsts) - marks["worker_dead"]
    start = res.counters["worker_startup_s"].get(2, {})
    rejoin = marks["worker_rejoined"] - t_spawn
    print(f"elastic alexnet sync_easgd tcp p2p P=4 ring 4MiB buckets, "
          f"{rounds} rounds, wid 2 killed at iteration {kill_at}: events "
          f"{[(e['kind'], e['wid'], e.get('detail', '')) for e in res.health['events']]}",
          flush=True)
    for line in lines:
        print(f"elastic alexnet {line}", flush=True)
    print(f"elastic alexnet time to recover (death seen by the master -> "
          f"first round of epoch 1 done by all {len(firsts)} survivors): "
          f"{recover:.3f} s (master's reconfigure after "
          f"{marks['reconfigure'] - marks['worker_dead']:.3f} s)", flush=True)
    print(f"elastic alexnet rejoin time (respawn -> worker_rejoined): "
          f"{rejoin:.3f} s; the rejoiner's import {start.get('import_s')} "
          f"s, to WELCOME (card init, dial, HELLO) "
          f"{start.get('to_welcome_s')} s, build {start.get('build_s')} s, "
          f"warm-up {start.get('warmup_s')} s; final eval "
          f"{res.final_metric:.4f}, {res.total_iters} iterations",
          flush=True)

    # one post-shrink bucket update at P = 3, kernel against plain
    _, grad_fn, _ = problem.build(device)
    n = res.center.numel()
    pad3 = n + (-n) % 3
    cuts = comm_rounds.default_bucket_boundaries(grad_fn.layer_sizes, pad3,
                                                 4 << 20)
    a, b = cuts[0], min(cuts[1], n)
    gen = torch.Generator(device=device).manual_seed(18)
    w = res.workers[0, a:b].clone()
    c = res.center[a:b].clone()
    row = res.workers[[0, 1, 3], a:b].sum(0)
    g = 1e-2 * torch.randn(b - a, dtype=torch.float64, device=device,
                           generator=gen)
    w_k, w_p = w.clone(), w.clone()
    c_k, c_p = torch.empty_like(c), torch.empty_like(c)
    eu.fused_sync_easgd_update(w_k, g, c, row, 3, easgd.eta, easgd.rho,
                               center_out=c_k)
    eu.fused_sync_easgd_update_ref(w_p, g, c, row, 3, easgd.eta, easgd.rho,
                                   center_out=c_p)
    check(torch.equal(w_k, w_p) and torch.equal(c_k, c_p),
          "post-shrink P=3 bucket update == plain version")
    print(f"elastic alexnet post-shrink bucket [{a}, {b}) at P=3: "
          f"fused_sync_easgd_update == plain version, bitwise", flush=True)

    # the numpy MLP: a SIGKILL shrink and a SIGTERM departure on the card,
    # each against the CPU's run with that worker SIGKILLed at the card
    # run's resume round (the round may vary by one), bit for bit whenever
    # each survivor drew as many gradients in epoch 0 in both runs: the
    # p2p plane is deterministic given those, but a rollback does not
    # rewind the problem's sampler, and a survivor that sees phase 1
    # before it starts the abandoned round draws one batch fewer
    mlp = EASGDConfig(eta=ETA, rho=RHO, mu=MU)
    shrink = {k.__name__: 0 for k in kernels.KERNELS}

    def elastic_run(chaos, dev):
        kernels.reset_launch_counts()
        r = runtime.run_ps(problems.NUMPY_MLP, mlp, runtime.PSConfig(
            algorithm="sync_easgd", n_workers=4, total_iters=240,
            transport="tcp", schedule="ring", sync_plane="p2p",
            eval_every_iters=10**9, elastic=True, chaos=chaos), device=dev)
        return r, kernels.launch_counts()

    for sig, wid in (("kill", 2), ("term", 1)):
        res, counts = elastic_run(
            {"wid": wid, "kill_at_iter": 20, "signal": sig}, device)
        resume = resume_rounds(res).get(1)
        check(resume is not None and abs(resume - 20) <= 1,
              f"elastic {sig}: resume round {resume}")
        cpu, _ = elastic_run(
            {"wid": wid, "kill_at_iter": resume, "signal": "kill"}, "cpu")
        events = [(e["kind"], e["wid"], e.get("detail", ""))
                  for e in res.health["events"]]
        draws = [{w: log[0]["grads"] for w, log in r.counters[
            "worker_epochs"].items() if w != wid} for r in (res, cpu)]
        check(resume_rounds(cpu) == resume_rounds(res)
              and res.total_iters == cpu.total_iters,
              f"elastic {sig} wid {wid}: resume rounds and iterations")
        same = draws[0] == draws[1]
        check(same_run(torch, res, cpu) or not same,
              f"elastic {sig} wid {wid}: card == CPU (killed at round "
              f"{resume}), bitwise ({events})")
        check(counts == only(counts, fused_sync_easgd_update=counts[
            "fused_sync_easgd_update"]), f"elastic {sig} launched {counts}")
        lines, _ = epoch_report(res, counts, 60, "fused_sync_easgd_update",
                                killed=1 if sig == "kill" else 0)
        add_counts(shrink, counts)
        if sig == "term":
            evs = {e["kind"]: e for e in res.health["events"]}
            check("worker_left" in evs
                  and evs["worker_left"]["detail"] == "preempted"
                  and res.health["membership"]["members"][1] == "left"
                  and res.health["epoch"] >= 1,
                  f"SIGTERM departure {res.health}")
        print(f"elastic {sig} wid {wid} at iteration 20, numpy MLP p2p P=4 "
              f"-> 3: " + (f"card == CPU killed at resume round {resume}, "
                           f"bitwise" if same else
                           f"epoch-0 draws differ, card {draws[0]} and CPU "
                           f"{draws[1]}: not compared bitwise")
              + f" (center, workers, {res.total_iters} iterations; events "
              f"{events}); final eval "
              f"{res.final_metric:.4f}; " + "; ".join(lines), flush=True)
    net = costmodel.Network("tiny-emu", 5e-3, 1e-9)
    res, sgd, t_spawn = run_with_respawn(
        runtime, server, kernels, problems.NUMPY_MLP, mlp, runtime.PSConfig(
            algorithm="sync_sgd", n_workers=4, total_iters=3200,
            transport="tcp", schedule="ring", sync_plane="p2p",
            eval_every_iters=10**9, elastic=True, emulate_net=net,
            telemetry_jsonl=str(PHASE18_DIR / "elastic_sgd.jsonl"),
            chaos={"wid": 2, "kill_at_iter": 10, "signal": "kill"}),
        PHASE18_DIR / "elastic_sgd.jsonl", device)
    logs = res.counters["worker_epochs"]
    check(sgd == only(sgd, fused_sync_sgd_update=sgd["fused_sync_sgd_update"])
          and [e["p"] for e in logs[2]] == [4]
          and [e["p"] for e in logs[0]] == [4, 3, 4]
          and math.isfinite(res.final_metric)
          and all(torch.equal(res.workers[i], res.center) for i in range(4)),
          f"p2p sync_sgd kill and rejoin: {sgd}, {logs}")
    lines, _ = epoch_report(res, sgd, 800, "fused_sync_sgd_update")
    rejoined = next(mono for kind, _, mono in res.counters[
        "membership_marks"] if kind == "worker_rejoined")
    print(f"elastic sync_sgd numpy MLP p2p P=4 -> 3 -> 4 (paced wire): "
          f"epoch 2, rejoin in {rejoined - t_spawn:.3f} s with "
          f"[center|velocity] relayed (every replica ends on the center, "
          f"bitwise); " + "; ".join(lines), flush=True)
    master = {k.__name__: 0 for k in kernels.KERNELS}
    for algo, upd in (("sync_easgd", "fused_sync_easgd_update"),
                      ("sync_sgd", "fused_sync_sgd_update")):
        kernels.reset_launch_counts()
        res = runtime.run_ps(problems.NUMPY_MLP, mlp, runtime.PSConfig(
            algorithm=algo, n_workers=3, total_iters=120,
            transport="tcp", schedule="ring", eval_every_iters=10**9,
            elastic=True,
            chaos={"wid": 2, "kill_at_iter": 8, "signal": "kill"}),
            device=device)
        counts = kernels.launch_counts()
        recon = [e for e in res.health["events"]
                 if e["kind"] == "reconfigure"]
        # the rosters the master served: [P, update launches, rounds]
        rosters = res.counters["sync_rosters"]
        want = sum(u * r for _, u, r in rosters)
        check(len(recon) == 1 and "p=2" in recon[0]["detail"]
              and res.health["epoch"] == 1 and res.total_iters >= 120
              and sum(q * r for q, _, r in rosters) == res.total_iters
              and {q for q, _, _ in rosters} == {2, 3}
              and counts == only(counts, **{upd: want}),
              f"master-plane {algo} kill: {res.health['events']}, {counts}, "
              f"rosters {rosters}")
        add_counts(master, counts)
        print(f"elastic master-plane {algo} numpy MLP P=3 -> 2: "
              f"{recon[0]['detail']}; {res.total_iters} iterations; rosters "
              f"served [P, launches, rounds] {rosters}; {upd} launches "
              f"{want} in the master, as the rosters give", flush=True)
    try:
        runtime.run_ps(problems.NUMPY_MLP, mlp, runtime.PSConfig(
            algorithm="sync_easgd", n_workers=2, total_iters=200,
            transport="tcp", schedule="ring", sync_plane="p2p",
            eval_every_iters=10**9,
            chaos={"wid": 1, "kill_at_iter": 10, "signal": "kill"}),
            device=device)
    except RuntimeError as exc:
        check("worker 1" in str(exc), f"elastic off names the worker: {exc}")
        print(f"elastic off: the kill is fatal, RuntimeError({str(exc)[:120]!r})",
              flush=True)
    else:
        check(False, "a kill with elastic off must fail the run")
    totals = {k.__name__: 0 for k in kernels.KERNELS}
    for c in (counts_alexnet, shrink, sgd, master):
        add_counts(totals, c)
    return totals


SOURCES = {"fused_sync_easgd_update": "elastic_update.cu",
           "fused_sync_sgd_update": "elastic_update.cu",
           "flash_attention_fwd": "flash_attention.cu",
           "flash_attention_bwd": "flash_attention.cu",
           "fused_ce_fwd": "fused_ce.cu", "fused_ce_bwd": "fused_ce.cu",
           "fused_elastic_update": "elastic_update.cu",
           "ssd_intra_fwd": "ssd_chunk.cu", "ssd_intra_bwd": "ssd_chunk.cu"}
FIRST_KEYS = ("name", "route", "source", "replaces", "launches",
              "max_abs_err", "tol", "ms", "plain_ms", "bound_ms", "bound_by",
              "library_ms")


def add_counts(totals: dict, counts: dict) -> None:
    for k, v in counts.items():
        totals[k] += v


def kernel_rows(rows: dict, launches: dict) -> list:
    """The ``kernels`` JSON line: one entry per kernel of the port, the
    contract's keys first, then what else the phases measured."""
    out = []
    for k, src in SOURCES.items():
        row = dict(rows[k], name=k, route="cuda", source=CSRC + src,
                   launches=launches[k])
        row.setdefault("library_ms", None)
        row.setdefault("tol", 0.0)          # the f64 updates: bitwise
        out.append({**{x: row[x] for x in FIRST_KEYS},
                    **{x: row[x] for x in row if x not in FIRST_KEYS}})
    return out


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
    import numpy as np
    import torch.nn.functional as F

    from repro_torch import configs, kernels
    from repro_torch.comm import rounds as comm_rounds
    from repro_torch.core import async_engine, costmodel, elastic
    from repro_torch.core.easgd import EASGDConfig
    from repro_torch.data import synthetic
    from repro_torch.kernels import _build
    from repro_torch.kernels import elastic_update as eu
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_ce as ce
    from repro_torch.kernels import ssd_chunk as sc
    from repro_torch.models import common
    from repro_torch.models import transformer as tfm
    from repro_torch.launch import train as launcher
    from repro_torch.net import server, wire
    from repro_torch.ps import problems, runtime, zoo
    from repro_torch.runtime import train
    from repro_torch.utils import timing

    card = card_line()
    name = torch.cuda.get_device_name(0)
    bw, f64, bf16, f32, tf32 = peaks_for(card)
    print(f"card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | peaks {bw / 1e12:g} TB/s, f64 "
          f"{f64 / 1e12:g} TFLOP/s, bf16 {bf16 / 1e12:g} TFLOP/s, f32 "
          f"{f32 / 1e12:g} TFLOP/s, TF32 {tf32 / 1e12:g} TFLOP/s", flush=True)
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(built)}",
          flush=True)
    for src, log in built.items():
        for line in log.splitlines():
            print(f"  nvcc[{src}] {line}")
    if "flash_attention" in built:
        print_attention_build(built["flash_attention"])
    if "fused_ce" in built:
        print_ce_build(built["fused_ce"], _build.library_path("fused_ce"))
    if "ssd_chunk" in built:
        print_ssd_build(built["ssd_chunk"], _build.library_path("ssd_chunk"))

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
    launches = phase_main_path(torch, runtime, zoo, kernels, EASGDConfig)
    print(f"phase main path: {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    rows.update(phase_attention(torch, F, fa, timing, dev, bw, bf16))
    rows.update(phase_cross_entropy(torch, F, ce, timing, dev, bw, bf16))
    print(f"phase lm kernels: {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    full = dataclasses.replace(configs.get("gemma3-4b").config, n_layers=6)
    check(tfm.n_params(full) == N_GEMMA_6L, "gemma3-4b at 6 layers")
    phase_full_width(torch, np, full, 4096, tfm, common, (fa, ce), kernels,
                     timing, dev)
    print(f"phase full width: {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    add_counts(launches, phase_lm_main_path(
        torch, runtime, zoo, kernels, comm_rounds, EASGDConfig, timing,
        configs.get("gemma3-4b").reduced))
    print(f"phase lm main path: {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    rows.update(phase_elastic_kernel(torch, eu, timing, dev, bw, f32))
    print(f"phase elastic kernel: {time.perf_counter() - t:.1f} s",
          flush=True)
    t = time.perf_counter()
    multi, counts = phase_multi_pod(torch, np, full, 4096, elastic,
                                    EASGDConfig, train, synthetic, eu,
                                    kernels, timing, dev, bw, f32)
    add_counts(launches, counts)
    rows["fused_elastic_update"].update(
        ms_in_step=multi["update_ms"],
        bound_ms_in_step=multi["update_bound_ms"])
    print(f"phase multi-pod: {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    add_counts(launches, phase_launcher_path(
        torch, np, configs, elastic, EASGDConfig, train, launcher, kernels,
        dev))
    print(f"phase launcher path: {time.perf_counter() - t:.1f} s",
          flush=True)

    # the Mamba-2 slice (phases 12-15)
    t = time.perf_counter()
    rows.update(phase_ssd(torch, sc, timing, dev, bw, f32, tf32))
    phase_cross_entropy(torch, F, ce, timing, dev, bw, bf16,
                        cases=CE_MAMBA2_CASES, rows=rows, suffix="_mamba2")
    print(f"phase ssd kernels: {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    mamba = configs.get("mamba2-780m").config
    check(tfm.n_params(mamba) == N_MAMBA2, "mamba2-780m at 48 layers")
    phase_full_width(torch, np, mamba, 4096, tfm, common, (fa, ce, sc),
                     kernels, timing, dev, held_dtype=torch.float32,
                     variant=lambda: f64_plain_ssd(sc))
    print(f"phase mamba2 full width: {time.perf_counter() - t:.1f} s",
          flush=True)
    t = time.perf_counter()
    multi, counts = phase_multi_pod(torch, np, mamba, 4096, elastic,
                                    EASGDConfig, train, synthetic, eu,
                                    kernels, timing, dev, bw, f32)
    add_counts(launches, counts)
    rows["fused_elastic_update"].update(
        ms_in_step_mamba2=multi["update_ms"],
        bound_ms_in_step_mamba2=multi["update_bound_ms"])
    print(f"phase mamba2 multi-pod: {time.perf_counter() - t:.1f} s",
          flush=True)
    t = time.perf_counter()
    add_counts(launches, phase_launcher_path(
        torch, np, configs, elastic, EASGDConfig, train, launcher, kernels,
        dev, arch="mamba2-780m", compressions=("none",)))
    add_counts(launches, phase_lm_main_path(
        torch, runtime, zoo, kernels, comm_rounds, EASGDConfig, timing,
        configs.get("mamba2-780m").reduced, arch="mamba2-780m",
        algos=("sync_easgd",)))
    print(f"phase mamba2 launcher path: {time.perf_counter() - t:.1f} s",
          flush=True)

    # the asynchronous slice (phase 16)
    release_card(torch, "before phase 16")
    t = time.perf_counter()
    add_counts(launches, phase_async_card_vs_cpu(
        torch, runtime, problems, async_engine, kernels, EASGDConfig))
    phase_async_alexnet(torch, runtime, zoo, kernels, EASGDConfig)
    add_counts(launches, phase_async_lm(torch, runtime, zoo, kernels, configs,
                                        EASGDConfig))
    add_counts(launches, phase_process(torch, runtime, problems, zoo, kernels,
                                       EASGDConfig))
    add_counts(launches, phase_ps_launcher(launcher, kernels))
    print(f"phase async: {time.perf_counter() - t:.1f} s", flush=True)

    # the tcp slice (phase 17)
    release_card(torch, "before phase 17")
    t = time.perf_counter()
    add_counts(launches, phase_tcp_bitwise(torch, runtime, problems, kernels,
                                           EASGDConfig))
    print(f"phase 17a: {time.perf_counter() - t:.1f} s", flush=True)
    t17 = time.perf_counter()
    notes: dict = {}
    add_counts(launches, phase_tcp_alexnet(torch, runtime, zoo, kernels,
                                           comm_rounds, wire, EASGDConfig,
                                           notes=notes))
    print(f"phase 17b: {time.perf_counter() - t17:.1f} s", flush=True)
    t17 = time.perf_counter()
    add_counts(launches, phase_trace_cost(torch, runtime, zoo, kernels,
                                          EASGDConfig))
    print(f"phase 17c: {time.perf_counter() - t17:.1f} s", flush=True)
    t17 = time.perf_counter()
    phase_tcp_entry_points()
    print(f"phase 17d: {time.perf_counter() - t17:.1f} s", flush=True)
    t17 = time.perf_counter()
    add_counts(launches, phase_tcp_lm(torch, runtime, zoo, kernels, configs,
                                      EASGDConfig))
    print(f"phase 17e: {time.perf_counter() - t17:.1f} s", flush=True)
    print(f"phase tcp (17): {time.perf_counter() - t:.1f} s", flush=True)

    # the live plane and elastic membership (phase 18)
    release_card(torch, "before phase 18")
    t = time.perf_counter()
    add_counts(launches, phase_elastic_bitwise(torch, runtime, problems,
                                               kernels, costmodel,
                                               EASGDConfig))
    print(f"phase 18a: {time.perf_counter() - t:.1f} s", flush=True)
    t18 = time.perf_counter()
    add_counts(launches, phase_live(torch, runtime, zoo, problems, kernels,
                                    costmodel, EASGDConfig, notes))
    print(f"phase 18b: {time.perf_counter() - t18:.1f} s", flush=True)
    t18 = time.perf_counter()
    add_counts(launches, phase_elastic(torch, runtime, zoo, problems,
                                       kernels, comm_rounds, eu, server,
                                       costmodel, EASGDConfig))
    print(f"phase 18c: {time.perf_counter() - t18:.1f} s", flush=True)
    print(f"phase elastic (18): {time.perf_counter() - t:.1f} s", flush=True)

    check("jax" not in sys.modules and not any(
        m == "repro" or m.startswith("repro.") for m in sys.modules),
        "no jax and no reference module imported")
    rows_out = kernel_rows(rows, launches)
    print(f"total: {time.perf_counter() - t0:.1f} s", flush=True)
    print(card)
    print(json.dumps({"kernels": rows_out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

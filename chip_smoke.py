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
   per gradient, each path's time the median of three gradients; the
   parameters one flat row through ``unflatten``, as the PS and multi-pod
   paths hold them, timed at remat "none" too;
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
   hogwild_easgd (``measured_over_des``); read, not held, async_msgd at
   η 0.001 (twice the η held), one real run and the DES in four seeded
   FCFS orders, each finite or not; (c) ``--model gemma3-4b`` with
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
   AlexNet, P = 4, ring, 4 MiB buckets, 4 rounds, Sync EASGD on the
   thread plane, the tcp master plane and the tcp p2p plane with overlap
   on, off and with sign_ef: µs/iter traced (the thread plane untraced
   too), the Table-3 shares, master / peer / wire bytes, exact update
   launches, the loopback
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
   P′ = 2) and a kill with elastic off, which must fail;
19. topology-aware scale-out (the card has one host, so a topology is
   emulated pacing): (a) the numpy MLP on the thread plane at P = 8, ring
   with no topology == ring under ``emulated_topology(1, 8)`` bit for bit,
   hierarchical under ``emulated_topology(2, 4)`` for Sync EASGD and Sync
   SGD card == CPU bit for bit, each round paced to ``t_rounds``; (b) P =
   16 under ``emulated_topology(2, 8)``, "auto" resolving hierarchical,
   and one ``measured_link_profile``; (c) the numpy MLP over tcp p2p at
   P = 4 under ``emulated_topology(2, 2)``, hierarchical, 8 iterations,
   both sync algorithms: per-link bytes == ``predicted_link_bytes``, the
   intra / cross totals its ``host_of`` partition, card == CPU bit for
   bit; (d) full-width AlexNet on tcp p2p, P = 4, 4 MiB buckets, 2 rounds
   a schedule, the intra class the loopback α–β and the cross class 20x
   its α and 4x its β: ring, hierarchical and "auto" from a tcp
   ``calibrate`` profile (``--burn`` interpreters), traced: µs/iter,
   shares, bytes against the prediction, each wid's paced exchange time
   against its measured one, exact launches; (e) ``launch.cluster
   --topology 2x2 --sync-plane p2p`` and ``launch.train --model jax-mlp
   --transport tcp`` as subprocesses, and jax-mlp on the card against the
   CPU (relative 1e-5);
20. per-slot remat and six more model families (every LM phase above runs
   with the configs' remat "full": each period slot's layer checkpointed,
   its attention or SSD forward launched again in the backward): (a) the
   full-width gradient (B 1, S 4096) with remat "full" against "none" on
   gemma3-4b at 6 layers, mamba2-780m at 48 and qwen1.5-4b at all 40: ms
   (median of 3) and peak memory of each, exact launches, loss and
   gradient on against off bit for bit where they are (else 1e-3 / 2e-2);
   (b) qwen1.5-4b (40 layers), phi3-mini-3.8b (32, attention at head dim
   96), musicgen-medium (48), recurrentgemma-2b (26: 8 periods and 2
   remainder RG-LRU layers), gemma3-27b (8) and qwen2-vl-72b (2, with
   distinct t / h / w M-RoPE positions and 256 patch embeddings from a
   seed) at full width, B 1, S 4096, bf16: loss and gradient through the
   kernels against the plain versions (1e-3 / 2e-2), exact launches, the
   families without qk-norm with q / k drawn at fan-in d_model (the
   reference's fan-in H makes their gradient chaotic at this width: a
   ``qk conditioning`` line reads both draws at f32, each beside the plain
   path against itself with attention and the CE in f64); (c) attention at
   phi3-mini's shape (B 1, S 4096, H 32, KVH 32, D 96) and at D 24 (H 4,
   KVH 2), bf16, timed against the plain version and
   scaled_dot_product_attention beside the bound, and both dims in f32,
   held; (d) the packed multi-pod step on recurrentgemma-2b at 8 layers
   (1,352,829,440 parameters), P = 2, B 1 per pod, S 4096, psum, overlap
   on, 3 steps, as phases 10 and 14; (e) for each of the six ids the
   reduced multi-pod step on the card against the CPU at f32 compute (2
   steps, loss 1e-3, params 2e-2) and ``launch.train --mode sync --arch <id>
   --reduced``, then ``launch.train --mode ps --model gemma3-27b`` on the
   thread transport (attention at D 24), each with exact launches;
21. the MoE and MLA families: (a) attention at deepseek-v2-236b's shape
   (B 1, S 4096, H 128 = KVH, Dqk 192, Dv 128, causal, bf16: the kernels'
   (256, 128) tiles) timed against the plain version and
   scaled_dot_product_attention (its backend named by its kernels)
   beside the bound, and in f32 at S 1024 and at the reduced pair (24,
   16) in both dtypes, held; (b) deepseek-v2-236b (5,020,697,600
   parameters) and grok-1-314b (6,530,598,912) at one layer each at the
   published widths, f32 leaves, bf16 compute, B 1, S 4096: loss and
   gradient through the kernels against the plain versions (1e-3 /
   2e-2, compared over two leaf groups), exact launches, ms and the peak
   against the card's memory, and how many of the first MoE layer's
   routing decisions the two paths' rounding flips (read, not held);
   deepseek-v2's gradient with remat full == none bit for bit; (c) both reduced ids on the multi-pod step (P = 2)
   against the CPU, ``launch.train --mode sync --arch <id> --reduced``
   and ``launch.train --mode ps --model <id>``, each with exact
   launches;
22. serving, under ``torch.inference_mode()`` with the leaves cast once
   (``transformer.cast_for_serving``): (a) gemma3-4b at full width and
   depth (34 layers: 25 local and 5 global in the periods, 4 local in the
   remainder), bf16, B 8 prompts of 4096, ``max_len`` 4224: one prefill
   with its launches counted (34 attention forwards, nothing else), its
   last-position logits held against the plain path's at the bf16 limit,
   a second prefill timed, then 128 greedy decode steps: prefill ms and
   tokens/s, the median decode ms a step, decoded tokens/s and the peak;
   (b) one decode step of gemma3-4b against caches of decode_32k's
   length 32,768 drawn at random, B cut from 128 to 32 to fit one card,
   every row at position 32,767: ms by the host clock and by CUDA events
   beside the bytes bound (weights, the f32 unembedding and every cache
   at the card's memory rate); (c) mamba2-780m at full width and depth
   (48 layers) as (a), 48 SSD forwards a prefill, the final SSM states
   held too; (d) deepseek-v2-236b at 1 layer (MLA's absorbed decode, the
   (192, 128) attention forward in the prefill, the MoE FFN at decode)
   and recurrentgemma-2b at all 26 layers (RG-LRU steps, local attention
   in its 2048-slot ring buffer), B 4, prompt 2048, 32 steps, held as (a);
   (e) at f32 compute, gemma3-4b at full width cut to 6 layers:
   ``prefill(1020)`` and 8 decode steps across the 1024-slot wrap equal
   ``forward(1028)``'s last logits to 1e-4, and the ten reduced configs'
   prefill and 8 decode steps on the card equal the CPU's to 1e-4;
23. multi-device placement (``launch.mesh``, ``runtime.sharding``,
   ``models.tp``) on the one card: the multi-pod step of phase 10
   (gemma3-4b at 6 layers, P = 2, B 1 per pod, S 4096, psum, overlap on)
   built with a ``(pod 1, data 1, model 1)`` mesh over a world of one
   NCCL process and without one, 2 steps each from the same seeded
   state, counters 0 before each step and read after: the meshed state
   equals the un-meshed one bit for bit after each step; ms per step of
   both (the mesh path's host cost), launches and peak; then two
   processes on the one card over gloo (NCCL takes one rank a card),
   meshed as ``model`` 2 (attention on half the heads, the loss head on
   131,072-column vocab shards) and as ``pod`` 2 (the packed exchange an
   all-reduce between the processes): the same 2 steps held against the
   world of one, the loss to 1e-3 and what the steps moved (the params'
   and the center's moves from the start, the momentum) by the relative
   norm of the error, to 5e-2, far below the 0.7 that a skipped pod sum
   reads (read in each run); exact launches, ms per step and the peak
   per rank;
24. the tooling (``core.costmodel``, ``launch.opcount``,
   ``launch.dryrun``): (a) phase 10's cell, one warm step counted by the
   op counter on the card path (each kernel wrapper a region counted by
   its formula), its FLOPs, bytes and roofline terms on the card's own
   data-sheet row beside the measured warm step (CUDA events and
   ``time_fn``): the step's roofline fraction; the dry run's peak
   estimate (fake tensors on the CPU) held to ``PEAK_LIMIT`` of
   ``max_memory_allocated``; the counter's kernel calls equal to the
   launch counters and phase 10's counts; (b) two production cells
   through ``launch.dryrun.run_cell`` (gemma3-4b ``train_4k`` on the
   ``(16, 16)`` mesh, gemma3-27b ``train_4k`` on ``(2, 16, 16)``), each
   on a fake world in a process of its own that starts with the script
   and runs on the host's CPU beside the card's phases (with (a)'s
   estimate): each record ok and fitting the device, its roofline terms
   printed as counts priced on the H100's data sheet; (c)
   ``examples/elastic_restart_torch.py --device cuda`` exits 0.

Each phase prints its seconds (and each sub-phase's from 16 on). Phase
17a's sync runs share their worker start-ups with the thread ↔ master ↔
p2p triangle, 17d starts its two entry points at once, and a gradient
above 4.5 B parameters is compared over two leaf groups (phase 20b's
gemma3-27b, 21b) rather than parked in host memory.

The last three lines are the card's name and power limit as ``nvidia-smi``
gives them, a JSON ``kernels`` line, and the JSON result line
``{"ok": true, "device": {...}}``. Without a GPU, or without the port's
sources beside this file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import atexit
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
N_RECURRENTGEMMA_8L = 1_352_829_440
CSRC = "src/repro_torch/kernels/csrc/"
KERNEL_SOURCE = CSRC + "elastic_update.cu"
# limits on the relative norm ||kernel - plain|| / ||plain|| of one output.
# f32 outputs take the f32 tolerances of tests/test_kernels.py whatever the
# inputs' dtype: lse and the cross-entropy loss are f32 sums of the same
# exact products in kernel and plain version. bf16 outputs take LIMIT_BF16,
# set from the card's readings (PERF.md).
LIMIT_F32 = {"fwd": 1e-5, "bwd": 1e-4}
# above this many parameters the params and two whole f32 gradients would
# not fit one card beside the activations: phase_full_width compares the
# two paths over two halves of the leaves
GROUPED_ABOVE = 4.5e9
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


def bound(n_bytes: float, n_ops: float, bw: float, rate: float) -> tuple:
    """``costmodel.bound_ms``: the package's one definition of a bound."""
    from repro_torch.core import costmodel
    return costmodel.bound_ms(n_bytes, n_ops, bw, rate)


def work_bound(work: tuple, bw: float, rate: float, products=1) -> tuple:
    """The bound of a kernel's ``(bytes, operations)`` from the package's
    ``costmodel.*_work``, its operations run ``products`` times."""
    n_bytes, n_ops = work
    return bound(n_bytes, products * n_ops, bw, rate)


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
    from repro_torch.core import costmodel as cm
    b_easgd, by_easgd = work_bound(cm.sync_easgd_work(n), bw, f64)
    b_solo, _ = work_bound(cm.sync_easgd_solo_work(n), bw, f64)
    b_sgd, by_sgd = work_bound(cm.sync_sgd_work(n), bw, f64)
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
                      r"(attn_\w+?_kernel)I(f|13__nv_bfloat16)?(?:Li(\d+)E)?"
                      r"(?:Li(\d+)E)?\S*)'")
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
    registers and spill bytes, from the build's ptxas output. An
    instantiation is named by its tile widths: ``D=<d>`` for an equal
    pair, ``D=<q/k tile>/<v tile>`` for an MLA pair."""
    for (_, ns, name, t, d, dv), regs, st, ld in ptxas_table(log):
        dtype = "bf16" if ns == "tc" or (t and "bfloat" in t) else "f32"
        route = ATTN_ROUTES.get((ns, name), "CUDA-core FMA")
        tile = d if dv in (None, d) else f"{d}/{dv}"
        print(f"attention build {name} {dtype} D={tile}: {route}, {regs} "
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
                    cases=ATTN_CASES, tag_timed="") -> dict:
    """Attention kernels against their plain versions; times at full
    width beside the bound and scaled_dot_product_attention, under keys
    ``ms<tag_timed>[_window<w>]`` and the like. A case's head dim is D,
    or a pair (D, Dv) where v, out and dout are Dv wide (MLA); with
    ``timed`` the library call's kernels are named (torch.profiler)."""
    rows = {"flash_attention_fwd": {}, "flash_attention_bwd": {}}
    for i, (B, S, H, KVH, D, causal, window, dt, timed) in \
            enumerate(cases):
        D, Dv = D if isinstance(D, tuple) else (D, D)
        dtype = getattr(torch, dt)
        gen = torch.Generator(device=dev).manual_seed(100 + i)
        q, k, v, do = (torch.randn(B, S, h, w, generator=gen, device=dev)
                       .to(dtype) for h, w in ((H, D), (KVH, D), (KVH, Dv),
                                               (H, Dv)))
        args = (causal, window)
        out, lse = fa.flash_attention_fwd(q, k, v, *args)
        p_out, p_lse = fa.flash_attention_fwd_ref(q, k, v, *args)
        grads = fa.flash_attention_bwd(q, k, v, out, lse, do, *args)
        p_grads = fa.flash_attention_bwd_ref(q, k, v, out, lse, do, *args)
        torch.cuda.synchronize()
        tag = (f"B={B} S={S} H={H} KVH={KVH} D={D}"
               f"{f' Dv={Dv}' if Dv != D else ''} causal={causal} "
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
        from repro_torch.core import costmodel as cm
        shape = (B, S, H, KVH, D, Dv, causal, window, q.element_size())
        b_fwd = work_bound(cm.attention_fwd_work(*shape), bw, bf16)
        b_bwd = work_bound(cm.attention_bwd_work(*shape), bw, bf16)
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
        suffix = tag_timed + ("" if window == 0 else f"_window{window}")
        if Dv != D:
            # the backend the library picks at this pair, by its kernels
            print(f"scaled_dot_product_attention {tag}: forward runs "
                  f"{kernel_times(torch, lib, t['fwd_lib'])}", flush=True)
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
        from repro_torch.core import costmodel as cm
        es = h.element_size()
        b_fwd = work_bound(cm.ce_fwd_work(T, d, V, es), bw, bf16)
        b_bwd = work_bound(cm.ce_bwd_work(T, d, V, es), bw, bf16)
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


def sq_parts(torch, got, want, dev, part=1 << 27) -> tuple:
    """``(Σ (got − want)², Σ want²)`` over two gradients given as lists of
    per-leaf tensors (on the card or the host), a part at a time on
    ``dev`` (sums in f64)."""
    num = den = 0.0
    for a_leaf, b_leaf in zip(got, want):
        a_leaf, b_leaf = a_leaf.reshape(-1), b_leaf.reshape(-1)
        for i in range(0, b_leaf.numel(), part):
            a = a_leaf[i:i + part].to(dev, torch.float64)
            b = b_leaf[i:i + part].to(dev, torch.float64)
            num += float(((a - b) ** 2).sum())
            den += float((b ** 2).sum())
    return num, den


def rel_norm_parts(torch, got, want, dev) -> float:
    """``rel_norm`` of two gradients given as lists of per-leaf tensors."""
    num, den = sq_parts(torch, got, want, dev)
    return math.sqrt(num / den)


def leaf_groups(params, common, k=2) -> list:
    """The leaf indices of ``params`` in ``k`` groups of about equal size
    (largest leaf first, each to the smallest group)."""
    sizes = [t.numel() for _, t in common.tree_leaves_with_path(params)]
    groups, totals = [set() for _ in range(k)], [0] * k
    for i in sorted(range(len(sizes)), key=lambda i: -sizes[i]):
        j = totals.index(min(totals))
        groups[j].add(i)
        totals[j] += sizes[i]
    return groups


# the query and key projections: dense attention's wq / wk, MLA's w_uq /
# w_uk (which contract over q_lora_rank / kv_lora_rank)
QK_LEAVES = (("attn", "wq"), ("attn", "wk"), ("attn", "w_uq"),
             ("attn", "w_uk"))


def lm_params(torch, tfm, common, cfg, dev, qk_fan_in_d=False):
    """The parameter pytree from ``torch.Generator`` seed 0 on ``dev``
    (f32 leaves); with ``qk_fan_in_d`` the query and key
    projections drawn with the std of fan-in their contraction dim (d_model
    for wq / wk, the lora ranks for MLA's w_uq / w_uk), where the
    reference's init takes fan-in H (the stacked shape's second-to-last
    dim): see ``phase_qk_conditioning`` for why the families without
    qk-norm need it at full width."""
    params = common.init_params(tfm.model_defs(cfg),
                                torch.Generator(device=dev).manual_seed(0),
                                device=dev)
    for path, t in common.tree_leaves_with_path(params):
        if qk_fan_in_d and path[-2:] in QK_LEAVES:
            t.mul_(math.sqrt(t.shape[-2] / t.shape[-3]))
    return params


def lm_gradient(torch, tfm, common, cfg, params, batch, only=None) -> tuple:
    """``lm_loss`` and its gradient with each parameter a leaf of its own:
    ``(loss, [per-leaf gradient], metrics)``; with ``only`` (a set of leaf
    indices) just those leaves take a gradient, the others' are None. (A
    flat row of views, as the PS and multi-pod paths hold the parameters,
    adds one row-sized concatenation at the end of the backward: its peak
    is 3n, where this one's is 2n and the activations.)"""
    leaves = [t.detach().requires_grad_(only is None or i in only)
              for i, (_, t) in enumerate(
                  common.tree_leaves_with_path(params))]
    loss, metrics = tfm.lm_loss(cfg, common.tree_unflatten(params, leaves),
                                batch)
    loss.backward()
    # detached: a metric still on the graph would keep every leaf, and so
    # its gradient, alive after the caller drops the gradient
    return loss.detach(), [t.grad for t in leaves], {
        k: v.detach() for k, v in metrics.items()}


def lm_batch(torch, np, cfg, S, dev, seed=7) -> dict:
    """B 1 of S tokens from ``seed``; for an M-RoPE config distinct t / h /
    w positions (the t stream the sequence; h and w a 16-wide grid over
    the patches, then the text's position) and ``patch_embed_tokens``
    patch embeddings of unit scale, all from the seed."""
    rng = np.random.RandomState(seed)
    tok = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                       size=(1, S + 1))).to(dev)
    batch = {"tokens": tok[:, :-1], "targets": tok[:, 1:],
             "mask": torch.ones((1, S), device=dev)}
    if cfg.mrope_sections is not None:
        s, P_ = np.arange(S), cfg.patch_embed_tokens
        hw = np.where(s < P_, s // 16, s - P_ + P_ // 16)
        ww = np.where(s < P_, s % 16, s - P_ + P_ // 16)
        batch["mrope_positions"] = torch.from_numpy(np.stack(
            [s, hw, ww])[:, None].astype(np.int64)).to(dev)
        batch["patch_embeds"] = torch.from_numpy(rng.randn(
            1, P_, cfg.d_model).astype(np.float32)).to(dev)
    return batch


def phase_full_width(torch, np, cfg, S, tfm, common, kernel_mods, kernels,
                     timing, dev, held_dtype=None, variant=None,
                     reps=3, flat_row=False) -> dict:
    """An LM at full width, B 1, S 4096 (gemma3-4b at 6 layers; mamba2-780m
    at all 48; phase 20b's six families): loss and gradient through the
    kernels against the plain versions, with exact launch counts per
    gradient. Each path's time is the median of ``reps`` gradients after
    the first (with ``reps`` 0, the first's own time); the peak is the
    first's, each parameter a leaf of its own (``lm_gradient``), or with
    ``flat_row`` all of them views of one row through ``tfm.unflatten``,
    as the PS and multi-pod paths hold them; that form also times its
    gradient at remat "none" (the form of PR 17's reading).

    With ``held_dtype``, the config's own (bf16) gradient is timed and its
    loss held, but its gradient is read, not held: beside it stands the
    reading of the plain path against itself with ``variant`` (a context
    that swaps in a second, more exact plain version), which is how far
    two valid evaluations of that gradient lie apart at this depth. The
    gradient is then held at ``held_dtype`` compute. Above 4.5 B
    parameters the params and two whole gradients would not fit beside
    the activations: the whole gradients are timed, counted and checked
    finite, and the two paths are then compared over two halves of the
    leaves (``leaf_groups``), each half's gradient taken through the
    kernels and through the plain versions with only its leaves
    requiring one; the relative norm sums over both halves. Without
    qk-norm the query and key projections are drawn at fan-in their
    contraction dim (``lm_params``). The peak is printed against the
    card's memory."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.cuda.empty_cache()
    qk_fan_in_d = not cfg.qk_norm and any(
        k in ("attn", "local", "mla") for k in cfg.layer_kinds())
    params = lm_params(torch, tfm, common, cfg, dev, qk_fan_in_d)
    n = sum(t.numel() for _, t in common.tree_leaves_with_path(params))
    groups = leaf_groups(params, common) if n > GROUPED_ABOVE else None
    check(not (groups and (flat_row or held_dtype)), "a grouped comparison "
          "takes neither flat_row nor held_dtype")
    batch = lm_batch(torch, np, cfg, S, dev)
    if flat_row:
        row = torch.cat([t.reshape(-1) for _, t in
                         common.tree_leaves_with_path(params)])
        params = None

    def gradient(c=cfg, only=None):
        if not flat_row:
            return lm_gradient(torch, tfm, common, c, params, batch, only)
        w = row.detach().requires_grad_(True)
        loss, metrics = tfm.lm_loss(c, tfm.unflatten(w, c), batch)
        loss.backward()
        return loss.detach(), [w.grad], {k: v.detach()
                                         for k, v in metrics.items()}

    def finite(grads):
        return all(bool(torch.isfinite(g).all()) for g in grads)

    def grouped_rel_grad() -> float:
        """The kernels' gradient against the plain versions', one leaf
        group at a time."""
        num = den = 0.0
        for g in groups:
            _, gk, _ = gradient(only=g)
            gk = [gk[i] for i in sorted(g)]
            with plain_versions(*kernel_mods):
                _, gp, _ = gradient(only=g)
            a, b = sq_parts(torch, gk, [gp[i] for i in sorted(g)], dev)
            num, den = num + a, den + b
            del gk, gp
        return math.sqrt(num / den)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with timing.Timer("cuda") as tm:
        loss_k, grad_k, metrics = gradient()
    first_ms = 1e3 * tm.elapsed
    counts = kernels.launch_counts()
    want = lm_counts(cfg, 1)
    check(counts == want, f"launches per full-width gradient {counts}")
    peak = torch.cuda.max_memory_allocated()
    check(math.isfinite(loss_k.item()) and finite(grad_k),
          "full-width loss and gradient finite")
    if groups:
        del grad_k

    def timed_ms(first, c=cfg):
        """Median host time of ``reps`` synchronised gradients: on this
        eager path one gradient alone drifts from run to run by more than
        a kernel's share of it (PERF.md §7)."""
        times = []
        for _ in range(reps):
            with timing.Timer("cuda") as tm:
                gradient(c)
            times.append(1e3 * tm.elapsed)
        times = times or [first]
        return statistics.median(times), times

    ms, ms_all = timed_ms(first_ms)
    with plain_versions(*kernel_mods):
        with timing.Timer("cuda") as tm:
            loss_p, grad_p, _ = gradient()
        plain_ms, plain_all = timed_ms(1e3 * tm.elapsed)
    rel_loss = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    if groups:
        del grad_p
        rel_grad = grouped_rel_grad()
    else:
        rel_grad = rel_norm_parts(torch, grad_k, grad_p, dev)
    check(rel_loss <= 1e-3, f"full-width loss kernels vs plain {rel_loss:.3e}")
    out = {"params": n, "loss": loss_k.item(), "loss_plain": loss_p.item(),
           "rel_loss": rel_loss, "rel_grad": rel_grad, "ms": ms,
           "ms_all": ms_all, "plain_ms": plain_ms, "plain_ms_all": plain_all,
           "peak_bytes": peak,
           "accuracy": metrics["accuracy"].item(), "launches": counts}
    held = "limit 2e-2"
    grad_k = None
    if held_dtype is None:
        check(rel_grad <= 2e-2, f"full-width gradient kernels vs plain "
              f"{rel_grad:.3e}")
    else:
        with plain_versions(*kernel_mods), variant():
            _, grad_v, _ = gradient()
        out["rel_grad_variant"] = rel_norm_parts(torch, grad_v, grad_p, dev)
        del grad_v
        held = (f"read, not held; the plain path against its more exact "
                f"variant reads {out['rel_grad_variant']:.3e}")
    grad_p = None
    total = torch.cuda.get_device_properties(dev).total_memory
    out["total_bytes"] = total
    print(f"full width {cfg.name} {cfg.n_layers} layers n={n} B=1 S={S} "
          f"{str(cfg.compute_dtype)[6:]} compute remat={cfg.remat}"
          f"{', one flat row through unflatten' if flat_row else ''}"
          f"{', q / k at fan-in of their contraction dim' if qk_fan_in_d else ''}"
          f"{', compared over 2 leaf groups' if groups else ''}: loss "
          f"kernels {out['loss']:.6f} plain {out['loss_plain']:.6f} (rel "
          f"{rel_loss:.3e}, limit 1e-3), gradient rel norm {rel_grad:.3e} "
          f"({held}); {ms:.1f} ms per gradient through the kernels "
          f"(median of {[round(v, 1) for v in ms_all]}), {plain_ms:.1f} ms "
          f"through the plain versions (median of "
          f"{[round(v, 1) for v in plain_all]}); peak "
          f"{peak / 2**30:.2f} GiB (max_memory_allocated) of the card's "
          f"{total / 2**30:.2f} GiB; launches per gradient {counts}",
          flush=True)
    if flat_row:
        off = dataclasses.replace(cfg, remat="none")
        kernels.reset_launch_counts()
        with timing.Timer("cuda") as tm:
            gradient(off)
        counts_off = kernels.launch_counts()
        check(counts_off == lm_counts(off, 1), f"launches per flat-row "
              f"gradient at remat none {counts_off}")
        out["none_ms"], out["none_ms_all"] = timed_ms(1e3 * tm.elapsed, off)
        print(f"full width {cfg.name} {cfg.n_layers} layers, one flat row "
              f"through unflatten, remat=none: {out['none_ms']:.1f} ms per "
              f"gradient through the kernels (median of "
              f"{[round(v, 1) for v in out['none_ms_all']]}); launches "
              f"{counts_off}", flush=True)
    if held_dtype is not None:
        torch.cuda.empty_cache()
        held_cfg = dataclasses.replace(cfg, compute_dtype=held_dtype)
        loss_k, grad_k, _ = gradient(held_cfg)
        with plain_versions(*kernel_mods):
            loss_p, grad_p, _ = gradient(held_cfg)
        out["held"] = {
            "dtype": str(held_dtype),
            "rel_loss": abs(loss_k.item() - loss_p.item()) / abs(
                loss_p.item()),
            "rel_grad": rel_norm_parts(torch, grad_k, grad_p, dev)}
        check(finite(grad_k), "held gradient finite")
        check(out["held"]["rel_loss"] <= 1e-3, f"full-width loss at "
              f"{held_dtype} kernels vs plain {out['held']['rel_loss']:.3e}")
        check(out["held"]["rel_grad"] <= 2e-2, f"full-width gradient at "
              f"{held_dtype} kernels vs plain {out['held']['rel_grad']:.3e}")
        print(f"full width {cfg.name} {cfg.n_layers} layers "
              f"{str(held_dtype)[6:]} compute: loss kernels "
              f"{loss_k.item():.6f} plain {loss_p.item():.6f} (rel "
              f"{out['held']['rel_loss']:.3e}, limit 1e-3), gradient rel "
              f"norm {out['held']['rel_grad']:.3e} (limit 2e-2)", flush=True)
        del grad_k, grad_p
    del params
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def f64_attention_ce(torch, fa, ce):
    """Inside ``plain_versions``: attention and the CE as dense f64
    functions of their inputs, rounded back to the inputs' dtypes (the
    same functions, more exactly than any f32 order of sums)."""
    saved = (fa.flash_attention_fwd, fa.flash_attention_bwd,
             ce.fused_ce_fwd, ce.fused_ce_bwd)

    def attend(q, k, v, causal, window):
        S, G = q.shape[1], q.shape[2] // k.shape[2]
        pos = torch.arange(S, device=q.device)
        keep = fa._tile_mask(pos, pos, causal, window)
        k, v = (t.double().repeat_interleave(G, dim=2) for t in (k, v))
        s = torch.einsum("bqhd,bkhd->bhqk", q.double(), k) / math.sqrt(
            q.shape[-1])
        s = s.masked_fill(~keep, float("-inf"))
        lse = torch.logsumexp(s, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", torch.exp(s - lse[..., None]),
                           v)
        return out, lse.transpose(1, 2)

    def attn_fwd(q, k, v, causal, window, *_):
        out, lse = attend(q, k, v, causal, window)
        return out.to(q.dtype), lse.float()

    def attn_bwd(q, k, v, out, lse, dout, causal, window, *_):
        with torch.enable_grad():
            xs = [t.detach().double().requires_grad_(True) for t in (q, k, v)]
            o, _ = attend(*xs, causal, window)
            grads = torch.autograd.grad(o, xs, dout.double())
        return tuple(g.to(t.dtype) for g, t in zip(grads, (q, k, v)))

    def ce_fwd(h, w, targets):
        logits = h.double() @ w.double()
        lse = torch.logsumexp(logits, dim=-1)
        tgt = logits.gather(1, targets[:, None])[:, 0]
        return (lse - tgt).float(), lse.float(), logits.argmax(dim=-1)

    def ce_bwd(h, w, targets, lse, g):
        p = torch.softmax(h.double() @ w.double(), dim=-1)
        p[torch.arange(h.shape[0], device=h.device), targets] -= 1.0
        dl = p * g[:, None].double()
        return ((dl @ w.double().t()).to(h.dtype),
                (h.double().t() @ dl).to(w.dtype))

    (fa.flash_attention_fwd, fa.flash_attention_bwd, ce.fused_ce_fwd,
     ce.fused_ce_bwd) = attn_fwd, attn_bwd, ce_fwd, ce_bwd
    try:
        yield
    finally:
        (fa.flash_attention_fwd, fa.flash_attention_bwd, ce.fused_ce_fwd,
         ce.fused_ce_bwd) = saved


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
    (W, V, G, C, M) are stored in ``sizes`` bytes per element
    (``costmodel.elastic_update_work``)."""
    from repro_torch.core import costmodel
    return work_bound(costmodel.elastic_update_work(p, n, sizes), bw, f32)


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
    imply: per pass one attention (``attn`` / ``local`` / ``mla``
    layers) or SSD (``ssm`` layers) forward per layer and one
    cross-entropy forward (a MoE FFN launches nothing), and for a
    gradient the backwards too; with remat (``cfg.remat`` other than
    "none") a gradient runs each period slot's forward once more, in its
    backward (the remainder layers and an eval's ``no_grad`` forward are
    not checkpointed); ``rglru`` layers launch nothing; the packed update
    ``updates`` times; the f64 updates none."""
    kinds = cfg.layer_kinds()
    period = cfg.n_periods * len(cfg.pattern)
    again = period if cfg.remat != "none" else 0

    def of(want):
        n = sum(k in want for k in kinds)
        n_again = sum(k in want for k in kinds[:again])
        return n * (grads + evals) + n_again * grads, n * grads

    attn_f, attn_b = of(("attn", "local", "mla"))
    ssd_f, ssd_b = of(("ssm",))
    check(set(kinds) <= {"attn", "local", "mla", "ssm", "rglru"},
          f"layer kinds {set(kinds)}")
    return {"fused_sync_easgd_update": 0, "fused_sync_sgd_update": 0,
            "flash_attention_fwd": attn_f, "flash_attention_bwd": attn_b,
            "fused_ce_fwd": grads + evals, "fused_ce_bwd": grads,
            "fused_elastic_update": updates,
            "ssd_intra_fwd": ssd_f, "ssd_intra_bwd": ssd_b}


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
    """Bounds of ``ssd_intra_fwd`` and ``ssd_intra_bwd`` on these shapes
    (``costmodel.ssd_fwd_work`` / ``ssd_bwd_work``), each product
    ``products`` times at ``rate`` (3 at the TF32 rate for the kernels'
    3xTF32 route, 1 at the CUDA cores' f32 rate)."""
    from repro_torch.core import costmodel as cm
    return (work_bound(cm.ssd_fwd_work(B, H, S, P, N, L), bw, rate, products),
            work_bound(cm.ssd_bwd_work(B, H, S, P, N, L), bw, rate, products))


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
# phase 16's η on AlexNet: async_msgd's master momentum (μ 0.9 on stale
# FCFS gradients) diverges at 0.005 and 0.002 within 64 iterations in a CPU
# run of these settings, and at 0.001 it went non-finite in one of three
# whole runs on the card (the FCFS order differs from run to run); phase
# 16b reads 0.001 beside it, the real run and the DES in seeded FCFS orders
ETA_ASYNC_ALEXNET = 0.0005
ETA_MSGD_READ = 0.001


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
                        async_engine, device="cuda",
                        des_seeds=range(4)) -> None:
    """(b) Full-width AlexNet, P = 4, thread transport, 64 iterations, each
    non-sync discipline for real (FCFS, lock-free, turnstile); then
    ``run_vs_des`` for async_easgd and hogwild_easgd. Last, read and not
    held: async_msgd at ``ETA_MSGD_READ``, one real FCFS run and the DES
    (no threads, so no race; its update is the reference's bit for bit,
    tests/test_torch_async.py) in the FCFS orders of ``des_seeds`` (compute
    jitter 0.1): whether each ends finite."""
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
    msgd = EASGDConfig(eta=ETA_MSGD_READ, rho=0.01, mu=MU)

    def finite(r):
        return bool(torch.isfinite(r.center).all()
                    and torch.isfinite(r.workers).all())

    real = runtime.run_ps(problem, msgd, dataclasses.replace(
        base, algorithm="async_msgd"), device=device)
    w0, grad_fn, eval_fn = problem.build(device)
    des = [finite(async_engine.PSEngine(
        grad_fn, eval_fn, w0, msgd, async_engine.SimConfig(
            n_workers=p, compute_jitter=0.1, seed=seed,
            eval_every_iters=10**9)).run("async_msgd", total_iters=iters))
        for seed in des_seeds]
    print(f"async_msgd alexnet P={p} eta={ETA_MSGD_READ} (read, not held): "
          f"real FCFS run finite {finite(real)}; DES finite by seed "
          f"{dict(zip(des_seeds, des))}", flush=True)


def phase_async_lm(torch, runtime, zoo, kernels, configs, EASGDConfig,
                   device="cuda") -> dict:
    """(c) The reduced LMs on the new disciplines, counters 0 before each
    run and read after: every worker warms up on 2 gradients; Original
    EASGD and Hogwild then compute exactly the quota, the async family
    under the turnstile one gradient more per worker (computed ahead of a
    turn that never comes); one final eval."""
    p, iters = 4, 16
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
    p, iters = 2, 40
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
    run equals the card's thread run and the CPU's thread run bit for bit,
    and for the sync algorithms the thread ↔ master ↔ p2p triangle on the
    card closes on the same configs (48 iterations: sync_easgd P 2 tree
    and P 3 ring, sync_sgd P 4 butterfly; async_easgd P 2 round_robin, 72
    iterations). The fused updates launch in the master (master plane) or
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

    # the sync runs share their worker start-ups with the triangle: one
    # tcp master run and one tcp p2p run per config, each held against
    # the card's thread run, which is held against the CPU's
    for algo, p, schedule in (("sync_easgd", 2, "tree"),
                              ("sync_easgd", 3, "ring"),
                              ("sync_sgd", 4, "butterfly"),
                              ("async_easgd", 2, "round_robin")):
        iters = 72 if algo == "async_easgd" else 48
        thr, c_thr = run(algo, p, iters, schedule, device)
        cpu, _ = run(algo, p, iters, schedule, "cpu")
        mst, c_mst = run(algo, p, iters, schedule, device, transport="tcp")
        upd = {"sync_easgd": "fused_sync_easgd_update",
               "sync_sgd": "fused_sync_sgd_update"}.get(algo)
        want = only(c_mst) if upd is None else only(c_mst, **{
            upd: iters if algo == "sync_easgd" else iters // p})
        check(c_mst == c_thr == want, f"{algo} P={p} launched {c_mst} over "
              f"tcp, {c_thr} in threads, expected {want}")
        check(same(mst, thr) and same(thr, cpu) and mst.total_iters == iters,
              f"{algo} P={p}: card tcp == card thread == CPU thread")
        add_counts(totals, c_mst)
        print(f"tcp {algo} numpy MLP P={p} {schedule} deterministic: card "
              f"tcp == card thread == CPU thread, bitwise; launches {want}; "
              f"worker spawn to READY {mst.counters['worker_ready_s']} s, "
              f"start-up {mst.counters['worker_startup_s']}", flush=True)
        if upd is None:
            continue
        p2p, c_p2p = run(algo, p, iters, schedule, device, transport="tcp",
                         sync_plane="p2p")
        check(c_p2p == only(c_p2p, **{upd: iters}),
              f"{algo} {schedule}: launches p2p {c_p2p}")
        check(same(thr, p2p) and p2p.schedule == f"{schedule}+p2p",
              f"{algo} P={p} {schedule}: thread == master == p2p")
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
    """(17b) Full-width AlexNet, P = 4, ring, 4 MiB buckets, 4 rounds,
    Sync EASGD five ways: thread, tcp master plane, tcp p2p with overlap on
    and off, tcp p2p with sign_ef. The thread plane untraced (µs/iter) and
    traced (the Table-3 shares), the tcp ways traced only (17c reads what
    tracing costs; phase 18b runs the p2p-overlap cell untraced as its
    telemetry-off run); the bytes on the master's links, on each peer
    link and in all; kernel 1's launches, exact; the loopback α–β."""
    p, rounds = 4, 4
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
        for trace in ((False, True) if name == "thread" else (True,)):
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
        traced = results[name, True]
        plain = results.get((name, False))
        c = traced.counters
        us = 1e6 * traced.total_time_s / (p * rounds)
        if notes is not None:
            notes[name] = us
        untraced = ("" if plain is None else
                    f"{1e6 * plain.total_time_s / (p * rounds):.1f} us/iter "
                    f"untraced, ")
        print(f"tcp-slice alexnet sync_easgd {name} P={p} ring 4MiB "
              f"buckets, {rounds} rounds: {untraced}{us:.1f} us/iter "
              f"traced; Table-3 shares (traced) "
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
        res = results[name, True]
        same = (torch.equal(res.center, ref.center)
                and torch.equal(res.workers, ref.workers))
        print(f"tcp-slice alexnet {name} == thread run bit for bit: {same}",
              flush=True)
    none = results["tcp p2p overlap", True].counters["peer_wire_bytes"]
    sign = results["tcp p2p sign_ef", True].counters["peer_wire_bytes"]
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
    """(17d) The entry points as subprocesses on the card, both at once:
    ``launch.train --transport tcp --sync-plane p2p --trace`` and
    ``launch.cluster``."""
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
    # both at once: they are checked for their paths, not timed
    t = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, *args], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for args in cmds]
    for proc, args in zip(procs, cmds):
        out, err_out = proc.communicate(timeout=600)
        lines = [ln for ln in out.splitlines() if " err=" in ln]
        check(proc.returncode == 0 and bool(lines), f"{args[1]} exited "
              f"{proc.returncode}: {err_out[-2000:]}")
        for line in lines:
            err = float(line.split(" err=")[1].split()[0])
            check(math.isfinite(err) and "[tcp/ring" in line
                  and f"@{device}" in line, f"line {line!r}")
            print(f"{args[1]}: {line[:400]}", flush=True)
        for line in out.splitlines():
            if " trace: " in line:
                print(f"{args[1]}: {line}", flush=True)
        print(f"{args[1]} as a subprocess on the card: exit 0, "
              f"{time.perf_counter() - t:.1f} s after both started",
              flush=True)


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
          + (f"; phase 17b traced {ref:.1f} us/iter" if ref else "")
          + f"; fused_sync_easgd_update launches {want} each", flush=True)

    port = free_port()
    net = costmodel.Network("tiny-emu", 5e-3, 1e-9)
    cfg = runtime.PSConfig(algorithm="hogwild_easgd", n_workers=3,
                           total_iters=240, transport="tcp", schedule="ring",
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
                  model="alexnet", rounds=110) -> dict:
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
        # which worker the master hears of first is a race: the killed
        # one's dropped socket or the survivor's ConnectionResetError
        check(re.search(r"worker \d+", str(exc)) is not None,
              f"elastic off names a worker: {exc}")
        print(f"elastic off: the kill is fatal, RuntimeError({str(exc)[:120]!r})",
              flush=True)
    else:
        check(False, "a kill with elastic off must fail the run")
    totals = {k.__name__: 0 for k in kernels.KERNELS}
    for c in (counts_alexnet, shrink, sgd, master):
        add_counts(totals, c)
    return totals


# ---------------------------------------------------------------------------
# phase 19: topology-aware scale-out and the jax-mlp problem
# ---------------------------------------------------------------------------

def host_split(per_link: dict, topo) -> tuple:
    """(intra-host, cross-host) totals of ``{(i, j): bytes}``."""
    intra = sum(b for (i, j), b in per_link.items()
                if topo.host_of(i) == topo.host_of(j))
    return intra, sum(per_link.values()) - intra


def phase_topology_thread(torch, runtime, problems, kernels, costmodel,
                          comm_rounds, comm_schedules, EASGDConfig,
                          device="cuda") -> dict:
    """(19a, 19b) The numpy MLP on the thread plane under emulated
    two-level fabrics (the PS wire inside a host; 20x its α and 4x its β
    across). (a) P = 8, 8 rounds: ring with no topology == ring under
    ``emulated_topology(1, 8)`` bit for bit; hierarchical under
    ``emulated_topology(2, 4)``, Sync EASGD and Sync SGD, card == CPU bit
    for bit (rows 1-2 against their plain versions under a topology), each
    round paced to ``t_rounds`` over the link classes. (b) P = 16 under
    ``emulated_topology(2, 8)``, schedule "auto": hierarchical, and one
    ``measured_link_profile`` of that fabric."""
    easgd = EASGDConfig(eta=ETA, rho=RHO, mu=MU)
    totals = {k.__name__: 0 for k in kernels.KERNELS}

    def run(algo, p, rounds, schedule, dev, topology):
        cfg = runtime.PSConfig(algorithm=algo, n_workers=p,
                               total_iters=p * rounds, schedule=schedule,
                               eval_every_iters=10**9, topology=topology)
        kernels.reset_launch_counts()
        res = runtime.run_ps(problems.NUMPY_MLP, easgd, cfg, device=dev)
        return res, kernels.launch_counts()

    p, rounds = 8, 8
    run("sync_easgd", p, 1, "ring", device, None)     # warm-up, not read
    flat, c_flat = run("sync_easgd", p, rounds, "ring", device, None)
    one, c_one = run("sync_easgd", p, rounds, "ring", device,
                     costmodel.emulated_topology(1, p))
    want = only(c_flat, fused_sync_easgd_update=p * rounds)
    check(c_flat == c_one == want, f"ring P={p}: launched {c_flat} flat, "
          f"{c_one} under 1x{p}, expected {want}")
    check(same_run(torch, flat, one), f"ring P={p}: emulated_topology(1, "
          f"{p}) == no topology, bitwise")
    add_counts(totals, c_flat)
    add_counts(totals, c_one)
    n = flat.center.numel()
    us = [1e6 * r.total_time_s / r.total_iters for r in (one, flat)]
    print(f"topology 1x{p} sync_easgd numpy MLP ring {rounds} rounds: == "
          f"the run with no topology, bitwise; {us[0]:.1f} us/iter paced on "
          f"the PS wire ({us[1]:.1f} unpaced); launches {want}", flush=True)
    topo = costmodel.emulated_topology(2, 4)
    hier = comm_schedules.get("hierarchical").rounds(p, n * 8, topology=topo)
    t_exch = comm_rounds.t_rounds(hier, n * 8, topology=topo)
    for algo, upd, n_upd in (("sync_easgd", "fused_sync_easgd_update",
                              p * rounds),
                             ("sync_sgd", "fused_sync_sgd_update", rounds)):
        card, c_card = run(algo, p, rounds, "hierarchical", device, topo)
        cpu, _ = run(algo, p, rounds, "hierarchical", "cpu", topo)
        check(c_card == only(c_card, **{upd: n_upd}),
              f"{algo} 2x4 launched {c_card}, expected {n_upd} {upd}")
        check(card.schedule == "hierarchical" and same_run(torch, card, cpu),
              f"{algo} 2x4 hierarchical: card == CPU")
        per_round = card.total_time_s / rounds
        check(per_round >= t_exch, f"{algo} 2x4: a round took "
              f"{per_round:.6f} s, under its paced exchange {t_exch:.6f} s")
        add_counts(totals, c_card)
        print(f"topology 2x4 {algo} numpy MLP P={p} hierarchical {rounds} "
              f"rounds: card == CPU, bitwise ({upd} == its plain version "
              f"under a topology, {n_upd} launches); "
              f"{1e6 * card.total_time_s / card.total_iters:.1f} us/iter, "
              f"{1e3 * per_round:.4f} ms a round against t_rounds "
              f"{1e3 * t_exch:.4f} ms (intra {topo.intra.alpha * 1e6:g} us "
              f"+ n/{9e6:g} B/s, cross 20x alpha 4x beta)", flush=True)
    # (19b)
    p16, topo16 = 16, costmodel.emulated_topology(2, 8)
    res, c16 = run("sync_easgd", p16, 4, "auto", device, topo16)
    check(res.schedule == "hierarchical"
          and c16 == only(c16, fused_sync_easgd_update=4 * p16),
          f"P=16 2x8 auto resolved {res.schedule}, launched {c16}")
    add_counts(totals, c16)
    prof = runtime.measured_link_profile(runtime.PSConfig(
        algorithm="sync_easgd", n_workers=p16, topology=topo16),
        device=device)
    t = prof.topology
    chosen = comm_schedules.choose(n * 8, p16, profile=prof)
    print(f"topology 2x8 sync_easgd numpy MLP P=16 auto: resolves "
          f"{res.schedule}, {1e6 * res.total_time_s / res.total_iters:.1f} "
          f"us/iter; measured_link_profile ({prof.source}, device copy "
          f"alpha {1e6 * prof.detail['alpha0_s']:.3f} us beta "
          f"{1e12 * prof.detail['beta0_s_per_byte']:.4f} ps/B): intra "
          f"alpha {1e6 * t.intra.alpha:.3f} us beta "
          f"{1e9 * t.intra.beta:.4f} ns/B, cross alpha "
          f"{1e6 * t.cross.alpha:.3f} us beta {1e9 * t.cross.beta:.4f} "
          f"ns/B; choose(profile=) -> {chosen}", flush=True)
    check(chosen == "hierarchical", f"the measured profile chose {chosen}")
    return totals


def phase_topology_tcp(torch, runtime, problems, kernels, costmodel,
                       comm_schedules, peer, EASGDConfig,
                       device="cuda") -> dict:
    """(19c) The numpy MLP over tcp p2p at P = 4 under
    ``emulated_topology(2, 2)``, hierarchical, 8 iterations, Sync EASGD and
    Sync SGD: every peer link moves ``predicted_link_bytes``, the
    intra / cross totals are its ``host_of`` partition (both > 0), the
    update launches in the workers exactly, and the card's run equals the
    CPU's bit for bit."""
    easgd = EASGDConfig(eta=ETA, rho=RHO, mu=MU)
    p, iters = 4, 8
    topo = costmodel.emulated_topology(2, 2)
    totals = {k.__name__: 0 for k in kernels.KERNELS}
    for algo, upd in (("sync_easgd", "fused_sync_easgd_update"),
                      ("sync_sgd", "fused_sync_sgd_update")):
        cfg = runtime.PSConfig(algorithm=algo, n_workers=p, total_iters=iters,
                               transport="tcp", schedule="hierarchical",
                               sync_plane="p2p", deterministic=True,
                               eval_every_iters=10**9, topology=topo)
        kernels.reset_launch_counts()
        res = runtime.run_ps(problems.NUMPY_MLP, easgd, cfg, device=device)
        counts = kernels.launch_counts()
        cpu = runtime.run_ps(problems.NUMPY_MLP, easgd, dataclasses.replace(
            cfg, transport="thread", sync_plane="master"), device="cpu")
        n = res.center.numel()
        per = peer.predicted_link_bytes(
            comm_schedules.get("hierarchical").rounds(p, n * 8,
                                                      topology=topo),
            n + (-n) % p)
        ex = iters // p
        want = {f"{i}-{j}": ex * b for (i, j), b in per.items()}
        intra, cross = (ex * b for b in host_split(per, topo))
        c = res.counters
        check(c["peer_link_bytes"] == want, f"{algo} 2x2 peer_link_bytes "
              f"{c['peer_link_bytes']}, predicted {want}")
        check(c["intra_host_bytes"] == intra and c["cross_host_bytes"]
              == cross and intra > 0 and cross > 0,
              f"{algo} 2x2 intra / cross {c.get('intra_host_bytes')} / "
              f"{c.get('cross_host_bytes')}, predicted {intra} / {cross}")
        check(counts == only(counts, **{upd: iters}),
              f"{algo} 2x2 tcp p2p launched {counts}")
        check(same_run(torch, res, cpu), f"{algo} 2x2 tcp p2p: card == CPU")
        add_counts(totals, counts)
        print(f"topology 2x2 {algo} numpy MLP tcp p2p hierarchical {iters} "
              f"iterations: card == CPU, bitwise; peer_link_bytes {want} "
              f"== predicted_link_bytes; intra_host_bytes {intra}, "
              f"cross_host_bytes {cross} == the host_of partition; {upd} "
              f"launches {iters} (in the workers); worker spawn to READY "
              f"{c['worker_ready_s']} s", flush=True)
    return totals


def phase_topology_alexnet(torch, runtime, zoo, kernels, costmodel,
                           comm_rounds, comm_schedules, peer, wire,
                           EASGDConfig, device="cuda") -> dict:
    """(19d) Full-width AlexNet on tcp p2p, P = 4, 4 MiB buckets, 2 rounds
    a schedule, under ``emulated_topology(2, 2)`` whose intra class is the
    loopback α–β ``wire.measure_link`` reads and whose cross class is 20x
    its α and 4x its β: ring, hierarchical and "auto" (resolved from a tcp
    ``calibrate`` profile, timed by ``--burn`` worker interpreters), each
    traced: µs/iter, the Table-3 shares, peer / intra / cross bytes
    against the prediction, each wid's paced exchange time against the
    exchange time it measured, and kernel 1's launches, exact."""
    p, rounds = 4, 2
    easgd = EASGDConfig(eta=0.005, rho=0.01, mu=MU)
    problem = zoo.resolve("alexnet")
    alpha, beta = wire.measure_link()
    intra = costmodel.Network("loopback (wire.measure_link)", alpha, beta)
    topo = costmodel.emulated_topology(2, 2, intra)
    print(f"topology-slice loopback link: alpha {1e6 * alpha:.2f} us, beta "
          f"{1e9 * beta:.4f} ns/B = {1e-9 / beta:.3f} GB/s; cross class "
          f"alpha {1e6 * topo.cross.alpha:.2f} us, beta "
          f"{1e9 * topo.cross.beta:.4f} ns/B", flush=True)
    _, grad_fn, _ = problem.build(device)
    n_pad = N_ALEXNET + (-N_ALEXNET) % p
    cuts = comm_rounds.default_bucket_boundaries(grad_fn.layer_sizes, n_pad,
                                                 4 << 20)
    live = sum(a < N_ALEXNET for a in cuts[:-1])
    base = runtime.PSConfig(algorithm="sync_easgd", n_workers=p,
                            total_iters=p * rounds, transport="tcp",
                            sync_plane="p2p", bucket_bytes=4 << 20,
                            deterministic=True, eval_every_iters=10**9,
                            topology=topo, trace=True)
    t0 = time.perf_counter()
    cal = runtime.calibrate(problem, dataclasses.replace(
        base, schedule="auto"), samples=3, device=device)
    auto = dataclasses.replace(base, schedule="auto").resolved_schedule(
        N_ALEXNET * 8, profile=cal.profile)
    pt = cal.profile.topology
    priced = ", ".join(
        f"{s} {comm_schedules.get(s).cost_topo(N_ALEXNET * 8, p, pt):.4f} s"
        for s in ("butterfly", "ring", "hierarchical"))
    print(f"topology-slice tcp calibrate ({time.perf_counter() - t0:.1f} s; "
          f"{p} --burn worker interpreters: {1e3 * cal.t_grad_concurrent:.2f}"
          f" ms a gradient concurrent, {1e3 * cal.t_grad_serial:.2f} serial)"
          f": profile {cal.profile.source} intra alpha "
          f"{1e6 * pt.intra.alpha:.2f} us beta {1e9 * pt.intra.beta:.4f} "
          f"ns/B, cross alpha {1e6 * pt.cross.alpha:.2f} us beta "
          f"{1e9 * pt.cross.beta:.4f} ns/B; auto resolves {auto} (priced "
          f"{priced})", flush=True)
    totals = {k.__name__: 0 for k in kernels.KERNELS}
    want = p * rounds * live
    for name, kw in (("ring", {"schedule": "ring"}),
                     ("hierarchical", {"schedule": "hierarchical"}),
                     ("auto", {"schedule": "auto",
                               "link_profile": cal.profile})):
        kernels.reset_launch_counts()
        res = runtime.run_ps(problem, easgd, dataclasses.replace(base, **kw),
                             device=device)
        counts = kernels.launch_counts()
        check(counts == only(counts, fused_sync_easgd_update=want),
              f"topology alexnet {name} launched {counts}, expected {want}")
        check(res.center.numel() == N_ALEXNET
              and bool(torch.isfinite(res.center).all())
              and bool(torch.isfinite(res.workers).all())
              and math.isfinite(res.final_metric)
              and res.total_iters == p * rounds, f"topology {name} finite")
        sched = res.schedule.split("+")[0]
        check(name != "auto" or sched == auto,
              f"auto ran {sched}, resolved {auto}")
        rr = comm_schedules.get(sched).rounds(p, N_ALEXNET * 8,
                                              topology=topo)
        per = peer.predicted_link_bytes(rr, n_pad, cuts)
        links = {f"{i}-{j}": rounds * b for (i, j), b in per.items()}
        intra_b, cross_b = (rounds * b for b in host_split(per, topo))
        c = res.counters
        check(c["peer_link_bytes"] == links
              and c.get("intra_host_bytes") == intra_b
              and c.get("cross_host_bytes") == cross_b,
              f"topology alexnet {name}: peer_link_bytes "
              f"{c['peer_link_bytes']} (predicted {links}), intra / cross "
              f"{c.get('intra_host_bytes')} / {c.get('cross_host_bytes')}")
        paced = [sum(comm_rounds.t_rounds_buckets(rr, n_pad, cuts,
                                                  topology=topo, wid=w))
                 for w in range(p)]
        per_w = {int(k): v for k, v in res.trace["report"]["workers"].items()}
        meas = [per_w[w]["comm_busy_s"] / rounds for w in range(p)]
        add_counts(totals, counts)
        print(f"topology-slice alexnet sync_easgd {name} -> {res.schedule} "
              f"P={p} 2x2, 4MiB buckets, {rounds} rounds, traced: "
              f"{1e6 * res.total_time_s / res.total_iters:.1f} us/iter; "
              f"Table-3 shares {shares(res)}; intra_host_bytes {intra_b}, "
              f"cross_host_bytes {cross_b} == predicted; paced exchange per "
              f"wid {[round(t, 4) for t in paced]} s, measured "
              f"{[round(t, 4) for t in meas]} s; fused_sync_easgd_update "
              f"launches {want} ({live} live buckets x {p} workers x "
              f"{rounds} rounds); worker spawn to READY "
              f"{c['worker_ready_s']} s", flush=True)
    return totals


def phase_topology_entry_points(torch, runtime, problems, zoo, kernels,
                                EASGDConfig, device="cuda") -> dict:
    """(19e) ``launch.cluster --workers 4 --topology 2x2 --sync-plane p2p``
    and ``launch.train --mode ps --model jax-mlp --transport tcp
    --ps-workers 2`` as subprocesses on the card; then jax-mlp on the
    thread plane, the card's run against the CPU's within the tests'
    f32 limit (relative norm of the center's move 1e-5)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC)
    cmds = ((["-m", "repro_torch.launch.cluster", "--workers", "4",
              "--topology", "2x2", "--sync-plane", "p2p", "--algorithm",
              "sync_easgd", "--schedule", "hierarchical", "--iters", "16",
              "--device", device], f"[tcp/hierarchical+p2p@{device}",
             "'cross_host_bytes'"),
            (["-m", "repro_torch.launch.train", "--mode", "ps", "--model",
              "jax-mlp", "--transport", "tcp", "--ps-workers", "2",
              "--algorithm", "sync_easgd", "--ps-iters", "16", "--emulate",
              "none", "--device", device], f"[tcp/ring@{device}",
             "ratio="))
    # both at once: they are checked for their paths, not timed
    t = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, *args], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for args, _, _ in cmds]
    errs = []
    for proc, (args, tag, field) in zip(procs, cmds):
        out, err_out = proc.communicate(timeout=600)
        lines = [ln for ln in out.splitlines() if " err=" in ln]
        check(proc.returncode == 0 and len(lines) == 1, f"{args[1]} exited "
              f"{proc.returncode}: {err_out[-2000:]}")
        err = float(lines[0].split(" err=")[1].split()[0])
        check(math.isfinite(err) and tag in lines[0] and field in lines[0],
              f"line {lines[0]!r}")
        errs.append(err)
        print(f"{args[1]} {' '.join(args[2:])}: exit 0 "
              f"{time.perf_counter() - t:.1f} s after both started: "
              f"{lines[0][:500]}", flush=True)
    easgd = EASGDConfig(eta=0.02, rho=0.01, mu=MU)
    cfg = runtime.PSConfig(algorithm="sync_easgd", n_workers=2,
                           total_iters=16, schedule="ring",
                           eval_every_iters=10**9)
    kernels.reset_launch_counts()
    card = runtime.run_ps(zoo.resolve("jax-mlp"), easgd, cfg, device=device)
    counts = kernels.launch_counts()
    cpu = runtime.run_ps(zoo.resolve("jax-mlp"), easgd, cfg, device="cpu")
    w0 = problems.make_jax_mlp(device="cpu")[0]
    moved = cpu.center - w0
    rel = float(torch.linalg.vector_norm(card.center.cpu() - w0 - moved)
                / torch.linalg.vector_norm(moved))
    check(rel <= 1e-5 and counts == only(counts, fused_sync_easgd_update=16),
          f"jax-mlp card vs CPU relative {rel:.3e} (limit 1e-5), "
          f"launches {counts}")
    print(f"jax-mlp sync_easgd P=2 16 iterations, thread plane: the card's "
          f"center move vs the CPU's, relative norm {rel:.3e} (limit 1e-5); "
          f"test error card {card.final_metric:.4f}, CPU "
          f"{cpu.final_metric:.4f}, the launcher's tcp run {errs[1]:.4f}; "
          f"launches {counts}", flush=True)
    return counts


# ---------------------------------------------------------------------------
# phase 20: per-slot remat and six more model families
# ---------------------------------------------------------------------------

# phase 20b: the six families at the published widths, depth cut only where
# one card forces it (f32 params and gradients 13.5-35 GiB); the f32 rows
# of those over 3.5 B parameters are compared on the host
FAMILIES = (("qwen1.5-4b", 40, 3_950_369_280),
            ("phi3-mini-3.8b", 32, 3_821_079_552),
            ("musicgen-medium", 48, 1_818_379_776),
            ("recurrentgemma-2b", 26, 2_894_574_080),
            ("gemma3-27b", 8, 4_712_393_984),
            ("qwen2-vl-72b", 2, 4_246_794_240))
# 20c: phi3-mini's attention at full width (D 96 on the 128-column tiles)
# and reduced gemma3-27b's head dim (24 on the 32-column tiles) at S 4096,
# timed; both dims in f32 on the CUDA cores, held
ATTN_D96_CASES = ((1, 4096, 32, 32, 96, True, 0, "bfloat16", True),
                  (1, 1024, 32, 32, 96, True, 0, "float32", False))
ATTN_D24_CASES = ((1, 4096, 4, 2, 24, True, 0, "bfloat16", True),
                  (1, 1024, 4, 2, 24, True, 8, "float32", False))
REMAT_CASES = (("gemma3-4b", 6), ("mamba2-780m", 48), ("qwen1.5-4b", 40))


def phase_remat(torch, np, cfg, S, tfm, common, kernels, timing, dev,
                reps=3) -> dict:
    """(20a) One full-width gradient (B 1, S 4096) with remat "full"
    against remat "none": the median of ``reps`` timed gradients and the
    peak of the first (``max_memory_allocated``; each parameter a leaf of
    its own, ``lm_gradient``), each with exact launches; loss and gradient
    on against off, bit for bit where they are, else held to 1e-3 / 2e-2.
    The "none" gradient stays on the card while "full" runs; its bytes
    are taken off "full"'s peak, so each peak is the run's own."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.empty_cache()
    params = lm_params(torch, tfm, common, cfg, dev)
    batch = lm_batch(torch, np, cfg, S, dev)
    out = {"params": tfm.n_params(cfg)}
    kept, held_over = {}, 0
    for remat in ("none", "full"):
        c = dataclasses.replace(cfg, remat=remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        loss, grads, _ = lm_gradient(torch, tfm, common, c, params, batch)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        check(counts == lm_counts(c, 1), f"remat={remat} {cfg.name} "
              f"launched {counts}, expected {lm_counts(c, 1)}")
        peak = torch.cuda.max_memory_allocated() - held_over
        kept[remat] = (loss, grads)
        held_over = sum(g.numel() * g.element_size() for g in grads)
        del grads
        times = []
        for _ in range(reps):
            with timing.Timer("cuda") as tm:
                lm_gradient(torch, tfm, common, c, params, batch)
            times.append(1e3 * tm.elapsed)
        out[remat] = {"ms": statistics.median(times), "ms_all": times,
                      "peak_bytes": peak, "launches": counts}
    (l0, g0), (l1, g1) = kept["none"], kept["full"]
    bitwise = torch.equal(l0, l1) and all(
        torch.equal(a, b) for a, b in zip(g0, g1))
    rel_loss = abs(l1.item() - l0.item()) / abs(l0.item())
    rel_grad = rel_norm_parts(torch, g1, g0, dev)
    check(bool(torch.isfinite(l1)) and all(
        bool(torch.isfinite(g).all()) for g in g1), f"remat {cfg.name} "
        f"finite")
    check(rel_loss <= 1e-3 and rel_grad <= 2e-2, f"remat {cfg.name} on vs "
          f"off: loss {rel_loss:.3e}, gradient {rel_grad:.3e}")
    out.update(bitwise=bitwise, rel_loss=rel_loss, rel_grad=rel_grad)
    on, off = out["full"], out["none"]
    print(f"remat {cfg.name} {cfg.n_layers} layers n={out['params']} B=1 "
          f"S={S}: full {on['ms']:.1f} ms (median of "
          f"{[round(v, 1) for v in on['ms_all']]}), peak "
          f"{on['peak_bytes'] / 2**30:.2f} GiB; none {off['ms']:.1f} ms "
          f"(median of {[round(v, 1) for v in off['ms_all']]}), peak "
          f"{off['peak_bytes'] / 2**30:.2f} GiB; on {on['ms'] / off['ms']:.3f}"
          f"x the time, {on['peak_bytes'] / off['peak_bytes']:.3f}x the "
          f"peak; loss and gradient on == off "
          + ("bit for bit" if bitwise else f"not bit for bit: loss rel "
             f"{rel_loss:.3e} (limit 1e-3), gradient rel norm "
             f"{rel_grad:.3e} (limit 2e-2)")
          + f"; launches per gradient full {on['launches']}, none "
          f"{off['launches']}", flush=True)
    del params, kept, g0, g1
    torch.cuda.empty_cache()
    return out


def phase_family_launchers(torch, np, configs, elastic, EASGDConfig, train,
                           launcher, kernels, dev, archs) -> dict:
    """(20e) Each arch of ``archs`` reduced: the multi-pod step (P = 2, B 2
    per pod, S 24, 2 steps) on the card against the CPU from the same
    state (loss 1e-3 relative, params by relative norm 2e-2) at f32
    compute, then ``launch.train --mode sync --arch <id> --reduced`` (the
    config's bf16) for 2 steps on the card, each with exact launches. The
    comparison runs at f32 because four of these reduced configs have no
    qk-norm, and at the reference's init their bf16 gradient lies farther
    from its f64 one than the bf16 limit (tests/torch_lm_parity.py)."""
    p, B, steps, S = 2, 2, 2, 24
    totals = {k.__name__: 0 for k in kernels.KERNELS}
    for arch in archs:
        spec = configs.get(arch)
        cfg = dataclasses.replace(spec.reduced, compute_dtype=torch.float32)
        rng = np.random.RandomState(1)
        batches = [{"tokens": rng.randint(0, cfg.vocab_size, (p, B, S)),
                    "targets": rng.randint(0, cfg.vocab_size, (p, B, S)),
                    "mask": np.ones((p, B, S), np.float32)}
                   for _ in range(steps)]
        want = lm_counts(cfg, p * steps, updates=steps)
        runs = []
        torch.backends.cuda.matmul.allow_tf32 = False
        for where in ("cpu", dev):
            ecfg = elastic.ElasticConfig(
                easgd=EASGDConfig(eta=0.05, rho=0.05, mu=MU),
                schedule="psum", center_dtype=spec.center_dtype,
                momentum_dtype=spec.momentum_dtype)
            build = train.build_train_step(cfg, ecfg, n_pods=p,
                                           per_pod_batch=B, seq=S,
                                           device=where)
            if where == "cpu":
                init = build.init_state()
            state = init.to(where)
            kernels.reset_launch_counts()
            losses = []
            for b in batches:
                state, metrics = build.step(state, b)
                losses.append(metrics["loss"].item())
            counts = kernels.launch_counts()
            if where != "cpu":
                check(counts == want, f"{arch} multi-pod launched {counts}, "
                      f"expected {want}")
                add_counts(totals, counts)
            runs.append((state.to("cpu"), losses))
        (cpu, cpu_losses), (card, card_losses) = runs
        rel_loss = max(abs(a - b) / abs(b)
                       for a, b in zip(card_losses, cpu_losses))
        rel_params = rel_norm(card.params, cpu.params)
        check(rel_loss <= 1e-3 and rel_params <= 2e-2, f"{arch}: card vs "
              f"CPU loss {rel_loss:.3e}, params {rel_params:.3e}")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            losses = launcher.main([
                "--arch", arch, "--reduced", "--n-pods", str(p), "--batch",
                str(p * B), "--seq", str(S), "--steps", str(steps),
                "--log-every", "1", "--device", torch.device(dev).type])
        counts = kernels.launch_counts()
        check(counts == want, f"launcher --arch {arch} launched {counts}, "
              f"expected {want}")
        check(len(losses) == steps and all(map(math.isfinite, losses)),
              f"launcher --arch {arch} losses finite")
        add_counts(totals, counts)
        print(f"launcher --mode sync --arch {arch} --reduced P={p} B={B} "
              f"S={S} {steps} steps: card vs CPU at f32 compute loss rel "
              f"{rel_loss:.3e} "
              f"(limit 1e-3), params rel norm {rel_params:.3e} (limit "
              f"2e-2); the launcher's losses {[round(x, 5) for x in losses]}"
              f", launches {counts}", flush=True)
    return totals


def phase_ps_model(launcher, kernels, configs, arch="gemma3-27b",
                   device="cuda") -> dict:
    """(20e) ``launch.train --mode ps --model <arch>`` on the thread
    transport, Sync EASGD, P = 2, 8 rounds: every worker warms up on 2
    gradients and takes one a round, one final eval, the update once per
    worker and round; the DES beside the run computes its own gradient
    per iteration (it runs the problem's ``grad_fn``), launching the LM
    kernels too. The launcher sets the counts to 0 after its
    calibration."""
    p, rounds = 2, 8
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        results = launcher.main([
            "--mode", "ps", "--model", arch, "--algorithm", "sync_easgd",
            "--transport", "thread", "--ps-workers", str(p), "--ps-iters",
            str(p * rounds), "--emulate", "none", "--device", device])
    text = out.getvalue()
    print(text, end="", flush=True)
    counts = kernels.launch_counts()
    want = lm_counts(configs.get(arch).reduced, 2 * p + 2 * p * rounds,
                     evals=1)
    want["fused_sync_easgd_update"] = p * rounds
    check(len(results) == 1 and math.isfinite(results[0].final_metric),
          f"--model {arch} finite")
    check(counts == want, f"--mode ps --model {arch} launched {counts}, "
          f"expected {want}")
    print(f"launcher --mode ps --model {arch} thread P={p} {rounds} rounds: "
          f"final eval loss {results[0].final_metric:.4f}, launches "
          f"{counts}", flush=True)
    return counts


def merge_rows(rows: dict, more: dict) -> None:
    """Fold a later phase's kernel rows into ``rows``: its tagged timings
    join them; the largest |error| and the reading nearest its limit
    stay."""
    for name, new in more.items():
        row = rows[name]
        err = max(row.get("max_abs_err", 0.0), new.pop("max_abs_err", 0.0))
        if new.get("err_to_tol", 0.0) < row.get("err_to_tol", 0.0):
            for k in ("rel_err", "tol", "err_to_tol"):
                new.pop(k, None)
        row.update(new, max_abs_err=err)


def phase_qk_conditioning(torch, np, configs, tfm, common, fa, ce, kernels,
                          dev, arch="musicgen-medium", layers=8) -> dict:
    """(20b) Why the families without qk-norm draw q / k at fan-in
    d_model: ``arch`` at full width, ``layers`` deep, f32 compute, one
    gradient through the kernels and one through the plain versions, at
    the reference's init and at fan-in d_model. Beside each, the plain
    path against itself with attention and the CE in f64
    (``f64_attention_ce``): where that gap is as large as the kernels',
    the gradient itself is ill-conditioned and no limit tells a right
    kernel from a wrong one. Read, not held."""
    cfg = dataclasses.replace(configs.get(arch).config, n_layers=layers,
                              compute_dtype=torch.float32)
    torch.backends.cuda.matmul.allow_tf32 = False
    batch = lm_batch(torch, np, cfg, 4096, dev)
    out = {}
    for fan_in_d in (False, True):
        params = lm_params(torch, tfm, common, cfg, dev, fan_in_d)
        loss_k, grad_k, _ = lm_gradient(torch, tfm, common, cfg, params,
                                        batch)
        with plain_versions(fa, ce):
            loss_p, grad_p, _ = lm_gradient(torch, tfm, common, cfg, params,
                                            batch)
        rel_k = rel_norm_parts(torch, grad_k, grad_p, dev)
        del grad_k
        with plain_versions(fa, ce), f64_attention_ce(torch, fa, ce):
            _, grad_v, _ = lm_gradient(torch, tfm, common, cfg, params,
                                       batch)
        out["fan_in_d" if fan_in_d else "reference"] = (
            abs(loss_k.item() - loss_p.item()) / abs(loss_p.item()),
            rel_k, rel_norm_parts(torch, grad_v, grad_p, dev))
        del params, grad_v, grad_p
    torch.cuda.empty_cache()
    print(f"qk conditioning {arch} {layers} layers f32 compute B=1 S=4096: "
          f"kernels vs plain at the reference's init (q / k fan-in H) loss "
          f"rel {out['reference'][0]:.3e}, gradient rel norm "
          f"{out['reference'][1]:.3e} (plain vs plain with attention and CE "
          f"in f64 {out['reference'][2]:.3e}); at fan-in d_model loss rel "
          f"{out['fan_in_d'][0]:.3e}, gradient rel norm "
          f"{out['fan_in_d'][1]:.3e} (plain vs f64 "
          f"{out['fan_in_d'][2]:.3e}) (read, not held)", flush=True)
    return out


def phase_families(torch, np, configs, tfm, common, fa, ce, kernels, timing,
                   dev) -> None:
    """(20b) The six families at full width (``FAMILIES``), B 1, S 4096,
    remat on, bf16 compute: loss and gradient through the kernels against
    the plain versions (1e-3 / 2e-2), one timed gradient each way, exact
    launches."""
    phase_qk_conditioning(torch, np, configs, tfm, common, fa, ce, kernels,
                          dev)
    for arch, layers, n in FAMILIES:
        cfg = dataclasses.replace(configs.get(arch).config, n_layers=layers)
        check(tfm.n_params(cfg) == n, f"{arch} at {layers} layers: "
              f"{tfm.n_params(cfg)} params")
        t = time.perf_counter()
        phase_full_width(torch, np, cfg, 4096, tfm, common, (fa, ce),
                         kernels, timing, dev, reps=0)
        print(f"phase 20b {arch}: {time.perf_counter() - t:.1f} s",
              flush=True)


# ---------------------------------------------------------------------------
# phase 21: the MoE and MLA families (grok-1-314b, deepseek-v2-236b)
# ---------------------------------------------------------------------------

# 21b: one layer each at the published widths (two would not fit one card:
# deepseek-v2 at 2 layers is 8,992,814,080 params, 72 GB of f32 leaves and
# gradients)
MOE_FAMILIES = (("deepseek-v2-236b", 1, 5_020_697_600),
                ("grok-1-314b", 1, 6_530_598_912))
# 21a: deepseek-v2's attention at full width (H 128, Dqk 192 = 128 nope +
# 64 rope, Dv 128), timed; in f32 at S 1024 and at the reduced pair (24,
# 16), held
ATTN_MLA_CASES = ((1, 4096, 128, 128, (192, 128), True, 0, "bfloat16", True),
                  (1, 1024, 128, 128, (192, 128), True, 0, "float32", False),
                  (2, 130, 4, 4, (24, 16), True, 0, "bfloat16", False),
                  (1, 1024, 4, 4, (24, 16), True, 8, "float32", False))


def phase_remat_grouped(torch, np, cfg, S, tfm, common, kernels, dev) -> bool:
    """(21b) The full-width gradient with remat "full" and "none", equal
    bit for bit: the MoE dispatch and combine gather (no atomics), so the
    recompute gives the forward's bits. Compared over two leaf groups
    (the params and two whole gradients would not fit), each with only
    its leaves requiring a gradient (so a group's backward launches only
    the kernels on its leaves' paths: the whole gradient's launches are
    held in ``phase_full_width``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    params = lm_params(torch, tfm, common, cfg, dev, not cfg.qk_norm)
    batch = lm_batch(torch, np, cfg, S, dev)
    same = True
    for g in leaf_groups(params, common):
        got = {}
        for remat in ("none", "full"):
            c = dataclasses.replace(cfg, remat=remat)
            loss, grads, _ = lm_gradient(torch, tfm, common, c, params,
                                         batch, only=g)
            got[remat] = (loss, [grads[i] for i in sorted(g)])
            del grads
        (l0, g0), (l1, g1) = got["none"], got["full"]
        same = same and torch.equal(l0, l1) and all(
            torch.equal(a, b) for a, b in zip(g0, g1))
        del got, g0, g1
    check(same, f"remat {cfg.name}: full == none, bit for bit")
    print(f"remat {cfg.name} {cfg.n_layers} layer full width B=1 S={S}: "
          f"loss and gradient remat full == none, bit for bit (over 2 leaf "
          f"groups)", flush=True)
    del params
    torch.cuda.empty_cache()
    return same


def routing_flips(torch, np, cfg, S, tfm, common, fa, ce, moe,
                  dev) -> tuple:
    """(21b) The first MoE layer's routing on a forward through the
    kernels and on one through the plain versions (the same params and
    batch, bf16 compute): how many tokens route to another expert set,
    and how many slots one path keeps and the other drops. Every such
    token takes a different function's gradient, so this counts how far
    the model's own discontinuities carry the kernels' rounding (read,
    not held)."""
    params = lm_params(torch, tfm, common, cfg, dev, not cfg.qk_norm)
    batch = lm_batch(torch, np, cfg, S, dev)
    real, seen = moe.route, []

    def first_route(*args, **kw):
        r = real(*args, **kw)
        seen.append(r)
        return r
    moe.route = first_route
    try:
        with torch.no_grad():
            tfm.lm_loss(cfg, params, batch)
            n_kernel = len(seen)
            with plain_versions(fa, ce):
                tfm.lm_loss(cfg, params, batch)
    finally:
        moe.route = real
    a, b = seen[0], seen[n_kernel]
    tokens = int((a.top_e.sort(-1).values != b.top_e.sort(-1).values)
                 .any(-1).sum())
    slots = int((a.keep != b.keep).sum())
    n_tok, n_slot = a.top_e.shape[0] * a.top_e.shape[1], a.keep.numel()
    print(f"routing {cfg.name} layer 0, kernels vs plain forward: {tokens} "
          f"of {n_tok} tokens route to another expert set, {slots} of "
          f"{n_slot} slots kept on one path and dropped on the other (C "
          f"{a.C} per expert and group of {a.Tg}; read, not held)",
          flush=True)
    del params
    torch.cuda.empty_cache()
    return tokens, slots


def phase_moe_families(torch, np, configs, tfm, common, fa, ce, kernels,
                       timing, dev) -> dict:
    """(21b) deepseek-v2-236b and grok-1-314b at one layer each, at the
    published widths, B 1, S 4096, remat on, f32 leaves, bf16 compute:
    loss and gradient through the kernels against the plain versions
    (1e-3 / 2e-2), the second of two gradients timed each way, exact
    launches, the peak against the card's memory, and how many routing
    decisions the two paths' rounding flips (``routing_flips``); then
    deepseek-v2's remat full == none bit for bit."""
    from repro_torch.models import moe
    out = {}
    for arch, layers, n in MOE_FAMILIES:
        cfg = dataclasses.replace(configs.get(arch).config, n_layers=layers)
        check(tfm.n_params(cfg) == n, f"{arch} at {layers} layer: "
              f"{tfm.n_params(cfg)} params")
        t = time.perf_counter()
        out[arch] = phase_full_width(torch, np, cfg, 4096, tfm, common,
                                     (fa, ce), kernels, timing, dev, reps=1)
        out[arch]["routing"] = routing_flips(torch, np, cfg, 4096, tfm,
                                             common, fa, ce, moe, dev)
        print(f"phase 21b {arch}: {time.perf_counter() - t:.1f} s",
              flush=True)
    t = time.perf_counter()
    phase_remat_grouped(torch, np, dataclasses.replace(
        configs.get("deepseek-v2-236b").config, n_layers=1), 4096, tfm,
        common, kernels, dev)
    print(f"phase 21b remat: {time.perf_counter() - t:.1f} s", flush=True)
    return out

# phase 22: serving. (arch, layers or None for all, B, prompt, max_len,
# decode steps): 22a gemma3-4b and 22c mamba2-780m at full width and depth,
# 22d deepseek-v2-236b at 1 layer and recurrentgemma-2b at all 26
SERVE_CASES = (("gemma3-4b", None, 8, 4096, 4224, 128),
               ("mamba2-780m", None, 8, 4096, 4224, 128),
               ("deepseek-v2-236b", 1, 4, 2048, 2080, 32),
               ("recurrentgemma-2b", None, 4, 2048, 2080, 32))
N_SERVE = {"gemma3-4b": 3_879_925_248, "mamba2-780m": N_MAMBA2,
           "deepseek-v2-236b": 5_020_697_600,
           "recurrentgemma-2b": 2_894_574_080}
# 22b: one decode step of gemma3-4b at decode_32k's cache length, the batch
# cut from the shape's 128 to 32 so that the caches fit one card
DECODE_32K = ("gemma3-4b", 32, 32768)


def serve_counts(cfg) -> dict:
    """The launches of one prefill: one attention forward per ``attn`` /
    ``local`` / ``mla`` layer, one SSD forward per ``ssm`` layer, nothing
    else (no loss; decode launches no kernel of the port)."""
    return dict(lm_counts(cfg, 0, evals=1), fused_ce_fwd=0)


def serve_params(torch, tfm, common, cfg, dev):
    """``lm_params`` (q / k at fan-in their contraction dim where the
    config has no qk-norm) cast once for serving; the f32 masters freed."""
    qk = not cfg.qk_norm and any(
        k in ("attn", "local", "mla") for k in cfg.layer_kinds())
    with torch.inference_mode():
        served = tfm.cast_for_serving(
            cfg, lm_params(torch, tfm, common, cfg, dev, qk))
    torch.cuda.empty_cache()
    return served, qk


def tree_bytes(common, tree, skip=()) -> int:
    return sum(t.numel() * t.element_size()
               for path, t in common.tree_leaves_with_path(tree)
               if path[0] not in skip)


class FirstCall:
    """A kernel wrapper that records its first call's arguments and
    result under ``key(args)`` in ``seen``; its ``launches`` are the
    wrapper's, so the wrapper's own count (which reads the module's name)
    goes on counting."""

    def __init__(self, fn, seen: dict, key):
        self.fn, self.seen, self.key = fn, seen, key

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, n):
        self.fn.launches = n

    def __call__(self, *args):
        out = self.fn(*args)
        self.seen.setdefault(self.key(args), (args, out))
        return out


@contextlib.contextmanager
def first_calls(fa, sc, seen: dict):
    """Record the first call of each kernel wrapper (attention per
    window) in ``seen``; the calls launch and count as before."""
    saved = fa.flash_attention_fwd, sc.ssd_intra_fwd
    fa.flash_attention_fwd = FirstCall(
        saved[0], seen, lambda a: ("flash_attention_fwd", a[4]))
    sc.ssd_intra_fwd = FirstCall(saved[1], seen,
                                 lambda a: ("ssd_intra_fwd", 0))
    try:
        yield
    finally:
        fa.flash_attention_fwd, sc.ssd_intra_fwd = saved


def hold_first_calls(fa, sc, seen: dict, what: str) -> dict:
    """Each recorded kernel call against its plain version on the same
    inputs (``hold``: bf16 outputs 1e-2, f32 1e-5); returns the rows."""
    rows = {}
    for (name, window), (args, out) in seen.items():
        row = rows.setdefault(name, {})
        tag = f"{what} {name} {tuple(args[0].shape)}" + (
            f" window {window}" if name == "flash_attention_fwd" else "")
        if name == "flash_attention_fwd":
            want = fa.flash_attention_fwd_ref(*args)
            hold(row, tag, "fwd", [("out", out[0], want[0]),
                                   ("lse", out[1], want[1])])
        else:
            hold(row, tag, "fwd", [("y", out, sc.ssd_intra_fwd_ref(*args))])
    seen.clear()
    return rows


def phase_serve(torch, np, cfg, B, S, max_len, steps, tfm, common, fa, sc,
                kernels, dev, held_dtype=None, variant=None) -> dict:
    """(22a, c, d) Serving at full width under ``torch.inference_mode()``:
    B prompts of S tokens (numpy seed 7), one prefill through the kernels
    with its launches counted (the attention or SSD forward once a layer,
    nothing else), the first call of each kernel (attention per window)
    held against its plain version on the same inputs, and the prefill's
    last-position logits (and for SSM layers the final states) held
    against the plain path's at the bf16 limit; a second prefill timed;
    then ``steps`` greedy decode steps, each timed by the host clock
    around a synchronised step. With ``held_dtype`` the config's own
    logits and states are read, not held, beside the plain path against
    itself with ``variant`` (a more exact plain version), and held at
    ``held_dtype`` compute instead, as phase 13 holds mamba2's gradient.
    Returns the readings, the first prefill's launches and the kernels'
    rows."""
    torch.cuda.empty_cache()
    served, qk = serve_params(torch, tfm, common, cfg, dev)
    prompt = torch.from_numpy(np.random.RandomState(7).randint(
        0, cfg.vocab_size, size=(B, S))).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def prefill(c=cfg, params=served):
        caches = tfm.init_caches(c, B, max_len, device=dev)
        t0 = time.perf_counter()
        logits, caches = tfm.prefill(c, params, prompt, caches)
        torch.cuda.synchronize()
        return logits, caches, 1e3 * (time.perf_counter() - t0)

    def rel_states(got, want):
        pairs = [(g["state"], w["state"]) for g, w, kind in zip(
            got["stacked"], want["stacked"], cfg.pattern) if kind == "ssm"]
        return math.sqrt(sum(float(((a - b) ** 2).sum()) for a, b in pairs)
                         / sum(float((b ** 2).sum()) for _, b in pairs))

    def against_plain(c=cfg, params=served, more=None):
        """Kernels vs the plain path (and the plain path against itself
        under ``more``): relative norms of the logits and SSM states."""
        logits, caches, _ = prefill(c, params)
        with plain_versions(fa, sc):
            logits_p, caches_p, plain_ms = prefill(c, params)
        got = {"logits": rel_norm(logits, logits_p), "plain_ms": plain_ms}
        if "ssm" in cfg.pattern:
            got["states"] = rel_states(caches, caches_p)
        if more is not None:
            with plain_versions(fa, sc), more():
                logits_v, caches_v, _ = prefill(c, params)
            got["variant"] = rel_norm(logits_v, logits_p)
            if "ssm" in cfg.pattern:
                got["variant_states"] = rel_states(caches_v, caches_p)
        return got

    seen: dict = {}
    with torch.inference_mode():
        kernels.reset_launch_counts()
        with first_calls(fa, sc, seen):
            logits, caches, first_ms = prefill()
        counts = kernels.launch_counts()
        check(counts == serve_counts(cfg), f"{cfg.name} launches per "
              f"prefill {counts}")
        check(bool(torch.isfinite(logits).all()), "prefill logits finite")
        del logits, caches
        rows = hold_first_calls(fa, sc, seen, f"serve {cfg.name} prefill")
        read = against_plain(more=variant if held_dtype else None)
        torch.cuda.empty_cache()
        parts = [f"logits rel norm {read['logits']:.3e}"] + (
            [f"final SSM states {read['states']:.3e}"] if "states" in read
            else [])
        if held_dtype is None:
            for k in ("logits", "states"):
                check(read.get(k, 0.0) <= LIMIT_BF16, f"{cfg.name} prefill "
                      f"{k} kernels vs plain {read.get(k, 0.0):.3e}")
            held = f"{', '.join(parts)} kernels vs plain (limit {LIMIT_BF16:g})"
        else:
            c32 = dataclasses.replace(cfg, compute_dtype=held_dtype)
            exact = against_plain(c32, tfm.cast_for_serving(c32, served))
            for k in ("logits", "states"):
                check(exact.get(k, 0.0) <= LIMIT_BF16, f"{cfg.name} prefill "
                      f"{k} at {held_dtype} kernels vs plain "
                      f"{exact.get(k, 0.0):.3e}")
            read["held"] = exact
            held = (f"{', '.join(parts)} kernels vs plain (read, not held; "
                    f"the plain path against its more exact variant reads "
                    f"logits {read['variant']:.3e}, states "
                    f"{read.get('variant_states', 0.0):.3e}); at "
                    f"{str(held_dtype)[6:]} compute logits "
                    f"{exact['logits']:.3e}, states "
                    f"{exact.get('states', 0.0):.3e} (limit {LIMIT_BF16:g})")
            torch.cuda.empty_cache()
        logits, caches, ms = prefill()
        tok = torch.argmax(logits, dim=-1)[:, None]
        step_ms = []
        for i in range(steps):
            pos = torch.full((B,), S + i, dtype=torch.int64, device=dev)
            t0 = time.perf_counter()
            logits, caches = tfm.decode_step(cfg, served, tok, caches, pos)
            tok = torch.argmax(logits, dim=-1)[:, None]
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
        check(bool(torch.isfinite(logits).all()), "decode logits finite")
    peak = torch.cuda.max_memory_allocated()
    out = {"prefill_ms": ms, "prefill_first_ms": first_ms,
           "prefill_plain_ms": read["plain_ms"],
           "prefill_tok_s": B * S / (ms / 1e3),
           "decode_ms": statistics.median(step_ms),
           "decode_tok_s": B * steps / (sum(step_ms) / 1e3),
           "peak_bytes": peak, "read": read, "launches": counts,
           "rows": rows}
    kinds = cfg.layer_kinds()
    print(f"serve {cfg.name} {cfg.n_layers} layers "
          f"({', '.join(f'{kinds.count(k)} {k}' for k in sorted(set(kinds)))}"
          f") n={tfm.n_params(cfg)} {str(cfg.compute_dtype)[6:]} compute, "
          f"leaves cast once"
          f"{', q / k at fan-in of their contraction dim' if qk else ''}: "
          f"B={B} prompt={S} max_len={max_len}; prefill {ms:.1f} ms "
          f"({out['prefill_tok_s']:.0f} tokens/s; the first {first_ms:.1f} "
          f"ms, the plain path's {read['plain_ms']:.1f} ms), {held}; "
          f"{steps} greedy decode steps: median {out['decode_ms']:.2f} ms a "
          f"step (min {min(step_ms):.2f}, max {max(step_ms):.2f}), "
          f"{out['decode_tok_s']:.0f} decoded tokens/s; peak "
          f"{peak / 2**30:.2f} GiB (max_memory_allocated); launches per "
          f"prefill {({k: v for k, v in counts.items() if v})}", flush=True)
    del served, caches
    torch.cuda.empty_cache()
    return out


def phase_decode_32k(torch, np, cfg, B, Sc, tfm, common, timing, dev,
                     bw) -> dict:
    """(22b) One decode step against caches of length ``Sc`` (drawn at
    random: a step's cost does not depend on the values), every row at
    position Sc − 1: the median host-clock ms of 5 synchronised steps and
    the median device time of 5 (CUDA events), beside the bytes bound (the
    block weights, B embedding rows, the f32 unembedding and every cache,
    each read once, at the card's memory rate), and one step's device
    time by kernel (torch.profiler)."""
    torch.cuda.empty_cache()
    served, _ = serve_params(torch, tfm, common, cfg, dev)
    with torch.inference_mode():
        caches = tfm.init_caches(cfg, B, Sc, device=dev)
        gen = torch.Generator(device=dev).manual_seed(3)
        for _, t in common.tree_leaves_with_path(caches):
            t.normal_(generator=gen)
        tok = torch.from_numpy(np.random.RandomState(5).randint(
            0, cfg.vocab_size, size=(B, 1))).to(dev)
        pos = torch.full((B,), Sc - 1, dtype=torch.int64, device=dev)
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()

        def step():
            return tfm.decode_step(cfg, served, tok, caches, pos)[0]
        host = []
        for _ in range(6):
            with timing.Timer("cuda") as tm:
                logits = step()
            host.append(1e3 * tm.elapsed)
        check(bool(torch.isfinite(logits).all()), "32k decode logits finite")
        dev_ms = timing.cuda_time_ms(step, reps=5, warmup=1)
        peak = torch.cuda.max_memory_allocated()
        by_kernel = kernel_times(torch, step, dev_ms)
    cache_bytes = tree_bytes(common, caches)
    n_bytes = (tree_bytes(common, served, skip=("embed",))
               + B * cfg.d_model * served["embed"].element_size()
               + cache_bytes)
    bound_ms = 1e3 * n_bytes / bw
    ms = statistics.median(host[1:])
    print(f"decode_32k {cfg.name} {cfg.n_layers} layers B={B} (decode_32k's "
          f"128 cut to {B} to fit one card) cache length {Sc}, position "
          f"{Sc - 1}: {ms:.2f} ms a step by the host clock (median of "
          f"{[round(v, 2) for v in host[1:]]}), {dev_ms:.2f} ms by CUDA "
          f"events (median of 5); bytes bound {bound_ms:.2f} ms "
          f"({n_bytes / 1e9:.2f} GB at {bw / 1e12:g} TB/s: caches "
          f"{cache_bytes / 1e9:.2f} GB, weights and the f32 unembedding "
          f"{(n_bytes - cache_bytes) / 1e9:.2f} GB), {bound_ms / dev_ms:.0%} "
          f"of it by device time; resident {resident / 2**30:.2f} GiB, a "
          f"step's peak {peak / 2**30:.2f} GiB (max_memory_allocated); by "
          f"kernel: {by_kernel}", flush=True)
    del served, caches
    torch.cuda.empty_cache()
    return {"ms": ms, "device_ms": dev_ms, "bound_ms": bound_ms,
            "bytes": n_bytes, "resident_bytes": resident, "peak_bytes": peak}


def phase_serve_identity(torch, np, configs, tfm, common, dev) -> None:
    """(22e) At f32 compute. The identity on the card: gemma3-4b at full
    width cut to 6 layers, B 1, ``prefill(1020)`` and 8 decode steps
    across the local layers' 1024-slot wrap give ``forward(1028)``'s last
    logits to 1e-4 (allclose, rtol = atol, as the reference's test); then
    the ten reduced configs (MoE at capacity factor 8) prefill 7 tokens of
    2 rows and decode 8 more on the card and on the CPU from the same
    params, every call's logits held at 1e-4."""
    def walk(cfg, params, tokens, n_prefill, max_len, d):
        with torch.inference_mode():
            caches = tfm.init_caches(cfg, tokens.shape[0], max_len, device=d)
            lg, caches = tfm.prefill(cfg, params, tokens[:, :n_prefill],
                                     caches)
            out = [lg]
            for t in range(n_prefill, tokens.shape[1]):
                pos = torch.full((tokens.shape[0],), t, device=d)
                lg, caches = tfm.decode_step(cfg, params,
                                             tokens[:, t:t + 1], caches, pos)
                out.append(lg)
        return out

    def close(a, b, tol=1e-4):
        """The largest |a − b| − tol·|b| (allclose holds where ≤ tol)."""
        a, b = a.double().cpu(), b.double().cpu()
        return float(((a - b).abs() - tol * b.abs()).max())

    torch.cuda.empty_cache()
    cfg = dataclasses.replace(configs.get("gemma3-4b").config, n_layers=6,
                              compute_dtype=torch.float32)
    params = lm_params(torch, tfm, common, cfg, dev)
    tokens = torch.from_numpy(np.random.RandomState(9).randint(
        0, cfg.vocab_size, size=(1, 1028))).to(dev)
    with torch.inference_mode():
        h, _, _ = tfm.forward(cfg, params, tokens)
        want = tfm.logits_at(cfg, params, h[:, -1])
    got = walk(cfg, params, tokens, 1020, 1028, dev)[-1]
    err = close(got, want)
    check(err <= 1e-4, f"identity prefill(1020) + 8 decode steps vs "
          f"forward(1028): {err:.3e}")
    print(f"identity {cfg.name} 6 layers f32 compute B=1: prefill(1020) + "
          f"8 decode steps across the 1024-slot wrap == forward(1028)'s "
          f"last logits: max(|a - b| - 1e-4 |b|) {err:.3e} (allclose at "
          f"rtol = atol = 1e-4), max |a - b| "
          f"{float((got - want).abs().max()):.3e}", flush=True)
    del params, h
    torch.cuda.empty_cache()
    worst = {}
    for arch in sorted(configs.ARCHS):
        cfg = dataclasses.replace(configs.get(arch).reduced,
                                  compute_dtype=torch.float32)
        if cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=8.0))
        cpu = common.init_params(tfm.model_defs(cfg),
                                 torch.Generator().manual_seed(0))
        card = common.tree_map(lambda t: t.to(dev), cpu)
        tokens = torch.from_numpy(np.random.RandomState(1).randint(
            0, cfg.vocab_size, size=(2, 15)))
        a = walk(cfg, card, tokens.to(dev), 7, 15, dev)
        b = walk(cfg, cpu, tokens, 7, 15, torch.device("cpu"))
        worst[arch] = max(close(x, y) for x, y in zip(a, b))
        check(worst[arch] <= 1e-4, f"{arch} reduced serving card vs CPU "
              f"{worst[arch]:.3e}")
    print(f"serving card vs CPU, ten reduced configs f32 compute, prefill 7 "
          f"+ 8 decode steps (across the window of 8): max(|card - cpu| - "
          f"1e-4 |cpu|) per arch {worst} (allclose at rtol = atol = 1e-4)",
          flush=True)


def phase_serving(torch, np, configs, tfm, common, fa, sc, kernels, timing,
                  dev, bw) -> dict:
    """Phase 22: 22a-d, then 22e; returns the prefills' launches and the
    kernels' rows from the holds at the prefills' shapes."""
    from repro_torch.utils.device import fp32_products
    fp32_products()
    launches, rows = {}, {}
    for i, (arch, layers, B, S, max_len, steps) in enumerate(SERVE_CASES):
        cfg = configs.get(arch).config
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        check(tfm.n_params(cfg) == N_SERVE[arch], f"{arch} params")
        t = time.perf_counter()
        ssm = "ssm" in cfg.pattern
        out = phase_serve(torch, np, cfg, B, S, max_len, steps, tfm, common,
                          fa, sc, kernels, dev,
                          held_dtype=torch.float32 if ssm else None,
                          variant=(lambda: f64_plain_ssd(sc)) if ssm
                          else None)
        for k, v in out["launches"].items():
            launches[k] = launches.get(k, 0) + v
        for k, row in out["rows"].items():
            if k in rows:
                merge_rows(rows, {k: row})
            else:
                rows[k] = row
        print(f"phase 22{'acdd'[i]} {arch}: {time.perf_counter() - t:.1f} s",
              flush=True)
        if i == 0:
            t = time.perf_counter()
            arch32, B32, Sc = DECODE_32K
            phase_decode_32k(torch, np, configs.get(arch32).config, B32, Sc,
                             tfm, common, timing, dev, bw)
            print(f"phase 22b: {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    phase_serve_identity(torch, np, configs, tfm, common, dev)
    print(f"phase 22e: {time.perf_counter() - t:.1f} s", flush=True)
    return launches, rows


# ---------------------------------------------------------------------------
# phase 23: multi-device placement
# ---------------------------------------------------------------------------

PHASE23_DIR = Path(__file__).resolve().parent / "build" / "phase23"
MESH_WORLDS = (("model 2", (1, 1, 2)), ("pod 2", (2, 1, 1)))


def mesh_easgd(elastic, EASGDConfig):
    """Phase 23's exchange: phase 10's (psum, overlap on)."""
    return elastic.ElasticConfig(easgd=EASGDConfig(eta=ETA, rho=RHO, mu=MU),
                                 schedule="psum", overlap=True)


HELD = ("params", "momentum", "center")
# relative norms of the error in what (a)'s steps moved: the params and
# the center from the center they started at, the momentum from 0. model
# 2 reads about 2e-2 in each (bf16 partial sums rounded before their
# all-reduce); the same hold of a reduced gemma3-4b on the CPU reads
# 1.3e-2 at bf16, and 0.84-0.86 with the model-parallel gradient's
# all-reduce left out; a pod sum skipped reads about 0.7 in the center's
# move (read in (a) on every run)
HELD_TOL = {"params": 5e-2, "momentum": 5e-2, "center": 5e-2}


def held_sums(torch, state, refs, cfg, mesh, pspecs) -> dict:
    """``{quantity: (||got - want||^2, ||want - start||^2)}`` for the
    params, momentum and center over this rank's block: ``refs`` is
    (a)'s ``(P, n)`` params and momentum and ``(n,)`` center after its
    steps and its center before them (CUDA IPC views of another process's
    tensors), cut to the rank's pods and shard leaf by leaf. ``start`` is
    where the steps began (every pod's params at the center, the momentum
    0), so each quantity is held against what the steps moved. A leaf
    that ``model`` does not split counts on model rank 0 alone."""
    from repro_torch.models import transformer as tfm
    from repro_torch.models.common import spec_leaves
    from repro_torch.runtime import sharding as shd
    w_ref, v_ref, c_ref, c0 = refs
    sizes = shd.mesh_axis_sizes(mesh)
    pl = state.params.shape[0]
    pod0 = mesh.get_local_rank("pod") * pl if sizes["pod"] > 1 else 0
    first = sizes["model"] == 1 or mesh.get_local_rank("model") == 0
    sums = {k: [0.0, 0.0] for k in HELD}

    def add(key, got, want, start):
        sums[key][0] += float(torch.linalg.vector_norm(got - want)) ** 2
        moved = want if start is None else want - start
        sums[key][1] += float(torch.linalg.vector_norm(moved)) ** 2

    off_l = off_f = 0
    for (_, lshape), (_, fshape), spec in zip(
            shd.local_layout(cfg, mesh), tfm.ravel_layout(cfg),
            spec_leaves(pspecs)):
        nl, nf = math.prod(lshape), math.prod(fshape)
        if first or "model" in shd.spec_axes(spec):
            cut = shd.local_slices(mesh, fshape, spec)
            full = slice(off_f, off_f + nf)
            start = c0[full].view(fshape)[cut]
            add("center", state.center[off_l:off_l + nl].view(lshape),
                c_ref[full].view(fshape)[cut], start)
            for i in range(pl):
                add("params", state.params[i, off_l:off_l + nl].view(lshape),
                    w_ref[pod0 + i, full].view(fshape)[cut], start)
                add("momentum",
                    state.momentum[i, off_l:off_l + nl].view(lshape),
                    v_ref[pod0 + i, full].view(fshape)[cut], None)
        off_l, off_f = off_l + nl, off_f + nf
    return {k: tuple(v) for k, v in sums.items()}


def mesh_rank(rank: int, store: str, cfg, S: int, batches, up, refs,
              out: str) -> None:
    """One of the two processes of phase 23 (b) and (c), on the one card:
    a gloo world of two (NCCL takes one rank a card), meshed first as
    ``model`` 2 and then as ``pod`` 2. Started while the parent stages
    (a)'s state, it joins its world and waits on ``refs`` for the
    parent's go; then,
    from phase 10's seeded state, the steps of (a), each timed and
    counted. Then it tells the parent on
    ``up`` that it has stepped, takes (a)'s state from ``refs`` (CUDA IPC
    views, which the parent uploads only now, beside the ranks' states
    and not beside their steps' peaks), holds its block against it, says
    so on ``up`` and waits on ``refs`` until the parent has freed them.
    Writes what it read to ``out``."""
    import datetime
    import traceback
    import torch
    import torch.distributed as dist
    from repro_torch import kernels
    from repro_torch.core import elastic
    from repro_torch.core.easgd import EASGDConfig
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.runtime import train
    from repro_torch.utils import timing
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=120))
    result = {}
    try:
        refs.get()      # the parent's go: (a) has left the card
        for name, (pods, data, model) in MESH_WORLDS:
            t0 = time.perf_counter()
            mesh = mesh_lib.make_host_mesh(data, model, n_pods=pods,
                                           device=dev)
            build = train.build_train_step(
                cfg, mesh_easgd(elastic, EASGDConfig), n_pods=2,
                per_pod_batch=1, seq=S, device=dev, mesh=mesh)
            torch.cuda.reset_peak_memory_stats()
            state = build.init_state()
            torch.cuda.empty_cache()
            r = result[name] = {"ms": [], "losses": [], "counts": [],
                                "local": list(state.params.shape)}
            for batch in batches:
                kernels.reset_launch_counts()
                with timing.Timer(dev) as tm:
                    state, metrics = build.step(state, batch)
                r["counts"].append(kernels.launch_counts())
                r["ms"].append(1e3 * tm.elapsed)
                r["losses"].append(metrics["loss"].item())
            r["peak"] = torch.cuda.max_memory_allocated()
            pspecs = build.param_specs
            del build, metrics
            torch.cuda.empty_cache()
            up.put((rank, "stepped"))
            t = time.perf_counter()
            views = refs.get()
            r["sums"] = held_sums(torch, state, views, cfg, mesh, pspecs)
            torch.cuda.synchronize()
            del views
            up.put((rank, "held"))
            refs.get()
            r["held_s"] = time.perf_counter() - t
            r["s"] = time.perf_counter() - t0
            del state
            torch.cuda.empty_cache()
    except BaseException:
        result["error"] = traceback.format_exc()
        up.put((rank, "error"))
    finally:
        dist.destroy_process_group()
    Path(out).write_text(json.dumps(result))


def start_mesh_ranks(cfg, S: int, batches) -> tuple:
    """Spawn the two processes of phase 23 (b) and (c), which import and
    join their world while this process stages (a)'s state (after (a)'s
    timed steps, which their imports would slow). Returns ``(procs, up,
    refs, outs)``."""
    shutil.rmtree(PHASE23_DIR, ignore_errors=True)
    PHASE23_DIR.mkdir(parents=True)
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    outs = [PHASE23_DIR / f"rank{r}.json" for r in range(2)]
    up, refs = ctx.Queue(), ctx.Queue()
    procs = [ctx.Process(target=mesh_rank, args=(
        r, str(PHASE23_DIR / "store"), cfg, S, batches, up, refs,
        str(outs[r]))) for r in range(2)]
    # two processes share the card beside this one: no segment reserved
    # and left unused (read when their CUDA starts)
    before = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        for pr in procs:
            pr.start()
    finally:
        if before is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = before
    return procs, up, refs, outs


def stop(procs, deadline: float) -> None:
    """Join ``procs`` until ``deadline``, then kill what still runs."""
    for pr in procs:
        pr.join(max(deadline - time.monotonic(), 0.1))
    for pr in procs:
        if pr.is_alive():
            pr.kill()
            pr.join()


def pinned(torch, t):
    """A copy of the card tensor ``t`` in page-locked host memory, which
    the link fills and drains faster than pageable memory."""
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)


def await_ranks(up, procs, what: str, deadline: float) -> bool:
    """Whether every rank of ``procs`` said ``what`` on ``up`` before
    ``deadline`` (False at once when one says ``error`` or dies)."""
    import queue
    heard = set()
    while len(heard) < len(procs):
        try:
            rank, said = up.get(timeout=1)
        except queue.Empty:
            if time.monotonic() > deadline or any(
                    pr.exitcode not in (None, 0) for pr in procs):
                return False
            continue
        if said != what:
            return False
        heard.add(rank)
    return True


def phase_mesh(torch, cfg, S, elastic, EASGDConfig, train, synthetic,
               kernels, timing, dev) -> dict:
    """(23) The multi-pod step of phase 10 on meshes. (a) A ``(pod 1,
    data 1, model 1)`` mesh over a world of one process (NCCL on the
    card, gloo on the CPU) against the same step without a mesh: 2 steps
    each in turns from the same seeded state, counters 0 before each step
    and read after; the states equal bit for bit after each step. (b, c)
    On the card, two processes over gloo (NCCL takes one rank a card):
    ``model`` 2 (attention on 4 of the 8 heads and 2 of the 4 kv heads a
    rank, the loss head on 131,072-column vocab shards) and ``pod`` 2
    (the packed exchange a real all-reduce between the processes), the
    same 2 steps each, held against (a): the losses to 1e-3 relative;
    the params, the momentum (``-eta`` times the gradients, after the
    first step) and the center's move (the second step's pod mean: the
    first exchange carries zero deltas, every pod starting at the center)
    by the relative norm of their error (``HELD_TOL``); exact launches per
    rank. (a) also reads how far a pod sum skipped on one rank would move
    the center's error, which the center's limit must stay far below.
    Returns the launches."""
    import numpy as np
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    p, steps = 2, 2
    ecfg = mesh_easgd(elastic, EASGDConfig)
    streams = [synthetic.SyntheticLMStream(cfg.vocab_size, S, 1, seed=13,
                                           shard=i, n_shards=p)
               for i in range(p)]
    batches = []
    for s in range(steps):
        shards = [st.batch_at(s) for st in streams]
        batches.append({k: np.stack([sh[k] for sh in shards])
                        for k in shards[0]})
    cuda = dev.type == "cuda"
    procs, up, refs, outs = [], None, None, []
    owned = not dist.is_initialized()
    backend = mesh_lib.backend_for(dev)
    if owned:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    totals = {k.__name__: 0 for k in kernels.KERNELS}
    names = ("un-meshed", "meshed")
    ms = {k: [] for k in names}
    losses = {k: [] for k in names}
    try:
        mesh = mesh_lib.make_host_mesh(1, 1, n_pods=1, device=dev)
        check(dist.get_backend() == backend and dist.get_world_size() == 1,
              f"a world of one over {backend}")
        builds = {name: train.build_train_step(
            cfg, ecfg, n_pods=p, per_pod_batch=1, seq=S, device=dev,
            mesh=mesh if name == "meshed" else None) for name in names}
        check(builds["meshed"].param_specs is not None, "meshed specs")
        timing.synchronize(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        states = {name: builds[name].init_state() for name in names}
        if dev.type == "cuda":
            # the draws' transients back to the card: cuBLAS allocates its
            # workspace outside the caching allocator
            torch.cuda.empty_cache()
        # where every pod starts (W = C), for what (b) and (c) moved
        stage_s = time.perf_counter()
        c0 = pinned(torch, states["meshed"].center) if cuda else None
        stage_s = time.perf_counter() - stage_s
        want = lm_counts(cfg, p, updates=1)
        for s in range(steps + 1):
            a, b = (states[name] for name in names)
            check(all(torch.equal(x, y) for x, y in (
                (a.params, b.params), (a.momentum, b.momentum),
                (a.center, b.center))),
                f"meshed state == un-meshed after {s} steps, bit for bit")
            if s == steps:
                break
            for name in names:
                kernels.reset_launch_counts()
                with timing.Timer(dev) as tm:
                    states[name], metrics = builds[name].step(states[name],
                                                              batches[s])
                counts = kernels.launch_counts()
                check(counts == want, f"{name} step {s} launched {counts}, "
                      f"expected {want}")
                for k, v in counts.items():
                    totals[k] += v
                ms[name].append(1e3 * tm.elapsed)
                losses[name].append(metrics["loss"].item())
            check(math.isfinite(losses["meshed"][-1])
                  and losses["meshed"][-1] == losses["un-meshed"][-1],
                  f"meshed loss == un-meshed at step {s + 1}")
            if s == 0:
                # the second exchange's pod mean is the mean of the first
                # momenta (W1 - C1 = V1): a rank that skipped the pod sum
                # would take its own V1 alone, an error of the other's
                v1 = states["meshed"].momentum
                skip = min(float(torch.linalg.vector_norm(v1[1 - r]))
                           for r in range(p)) / float(
                               torch.linalg.vector_norm(v1.sum(0)))
        check(HELD_TOL["center"] * 10 <= skip,
              f"the center's limit {HELD_TOL['center']} is not far below "
              f"a skipped pod sum's error {skip:.3e}")
        peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
        if cuda:
            t0 = time.perf_counter()
            procs, up, refs, outs = start_mesh_ranks(cfg, S, batches)
        # (a)'s state after the last step: what (b) and (c) are held
        # against, in host memory while their ranks step
        final = states["meshed"]
        t = time.perf_counter()
        host = [pinned(torch, x) for x in (
            final.params, final.momentum, final.center)] + [c0] if cuda \
            else None
        stage_s += time.perf_counter() - t
        del states, builds, a, b, final, v1
    except BaseException:
        stop(procs, 0)
        raise
    finally:
        if owned:
            dist.destroy_process_group()
    print(f"mesh world of 1 over {backend}: {cfg.name} {cfg.n_layers} "
          f"layers P={p} B=1 S={S} psum overlap, {steps} steps in turns "
          f"from one seeded state: the meshed state == the un-meshed one, "
          f"bit for bit, after every step; ms per step un-meshed "
          f"{[round(x, 1) for x in ms['un-meshed']]}, meshed "
          f"{[round(x, 1) for x in ms['meshed']]}; losses "
          f"{[round(x, 6) for x in losses['meshed']]}; peak "
          f"{peak / 2**30:.2f} GiB (both states resident); launches per "
          f"step {want}; a pod sum skipped on one rank would read "
          f"{skip:.3e} in the center's move; its state to pinned host "
          f"memory {stage_s:.1f} s", flush=True)
    if dev.type != "cuda":
        return totals

    # (b), (c): the two processes on the one card, started before the
    # staging
    release_card(torch, "before phase 23b-c")
    t_go = time.perf_counter()
    for _ in procs:
        refs.put(None)
    deadline = time.monotonic() + 300
    upload_s = []
    for name, _ in MESH_WORLDS:
        if not await_ranks(up, procs, "stepped", deadline):
            break
        t = time.perf_counter()
        views = tuple(x.to(dev) for x in host)
        torch.cuda.synchronize()
        upload_s.append(time.perf_counter() - t)
        for _ in procs:
            refs.put(views)
        held = await_ranks(up, procs, "held", deadline)
        del views
        torch.cuda.ipc_collect()
        torch.cuda.empty_cache()
        if not held:
            break
        for _ in procs:
            refs.put(None)
    stop(procs, deadline)
    wall, after_go = time.perf_counter() - t0, time.perf_counter() - t_go
    del host
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()
    check([pr.exitcode for pr in procs] == [0, 0],
          f"phase 23 ranks exit codes {[pr.exitcode for pr in procs]}")
    res = [json.loads(o.read_text()) for o in outs]
    for r, out in enumerate(res):
        check("error" not in out, f"phase 23 rank {r}: {out.get('error')}")
    for name, (pods, _, _) in MESH_WORLDS:
        rows = [out[name] for out in res]
        local_pods = p // pods
        want_rank = lm_counts(cfg, local_pods, updates=1)
        for r, row in enumerate(rows):
            for s, counts in enumerate(row["counts"]):
                check(counts == want_rank, f"{name} rank {r} step {s} "
                      f"launched {counts}, expected {want_rank}")
                for k, v in counts.items():
                    totals[k] += v
        rel_loss = max(abs(x - y) / abs(y) for row in rows
                       for x, y in zip(row["losses"], losses["meshed"]))
        rel = {k: math.sqrt(sum(row["sums"][k][0] for row in rows)
                            / sum(row["sums"][k][1] for row in rows))
               for k in HELD}
        print(f"mesh world {name} (gloo, 2 processes on one card): "
              f"{cfg.name} {cfg.n_layers} layers P={p} B=1 S={S} psum "
              f"overlap: vs (a) loss rel {rel_loss:.3e} (limit 1e-3); "
              f"relative error in what the steps moved: "
              + ", ".join(f"{k} {rel[k]:.3e} (limit {HELD_TOL[k]})"
                          for k in HELD)
              + f"; ms per step "
              f"{[[round(x, 1) for x in row['ms']] for row in rows]} "
              f"(rank 0, rank 1); local rows {rows[0]['local']}; peak per "
              f"rank {[round(row['peak'] / 2**30, 2) for row in rows]} "
              f"GiB; launches per rank and step {want_rank}; "
              f"{max(row['s'] for row in rows):.1f} s with the build, init "
              f"and the hold ({max(row['held_s'] for row in rows):.1f} s)",
              flush=True)
        check(rel_loss <= 1e-3, f"{name}: loss vs (a) {rel_loss:.3e}")
        for k in HELD:
            check(rel[k] <= HELD_TOL[k], f"{name}: {k} vs (a) "
                  f"{rel[k]:.3e}, limit {HELD_TOL[k]}")
    print(f"phase 23b-c: {after_go:.1f} s for both worlds after the go "
          f"({wall:.1f} s from the spawn, beside the staging); (a)'s "
          f"state to the card {[round(x, 1) for x in upload_s]} s",
          flush=True)
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


# phase 24: the dry run's counts on the host's CPU, in a process of its
# own started with the script (``--dryrun-cells``; the fake world of 256
# or 512 ranks must not meet this process's groups): phase 10's cell's
# peak estimate first (24a), then two production cells (24b)
DRYRUN_CELLS = (("gemma3-4b", "train_4k", "pod"),
                ("gemma3-27b", "train_4k", "multipod"))
DRYRUN_OUT = Path(__file__).resolve().parent / "build" / "dryrun_cells"
# phase 24a: |estimated / measured peak - 1| of the step's device memory.
# The probe read 0.9995 (46.525 of 46.548 GiB); 2 % is 40 times that and
# holds the cuBLAS workspaces and kernel scratch an earlier phase may
# already hold (PERF.md §6, PR 26)
PEAK_LIMIT = 0.02


def phase10_cell(configs, elastic, EASGDConfig) -> tuple:
    """Phase 10's cell: gemma3-4b at 6 layers, P = 2, B 1 per pod, S 4096,
    psum, overlap on; ``(cfg, ecfg, P, S)``."""
    cfg = dataclasses.replace(configs.get("gemma3-4b").config, n_layers=6)
    ecfg = elastic.ElasticConfig(easgd=EASGDConfig(eta=ETA, rho=RHO, mu=MU),
                                 schedule="psum", overlap=True)
    return cfg, ecfg, 2, 4096


def dryrun_child() -> int:
    """``chip_smoke.py --dryrun-cells``: the CPU's part of phase 24, on
    fake tensors (no device): the peak estimate and counts of phase 10's
    cell, then ``launch.dryrun.run_cell`` on ``DRYRUN_CELLS``."""
    sys.path.insert(0, str(SRC))
    from repro_torch import configs
    from repro_torch.core import elastic
    from repro_torch.core.easgd import EASGDConfig
    from repro_torch.launch import dryrun
    cfg, ecfg, p, S = phase10_cell(configs, elastic, EASGDConfig)
    t = time.perf_counter()
    est, peak = dryrun.count_step(lambda: dryrun.train_step(
        cfg, ecfg, n_pods=p, per_pod_batch=1, seq=S))
    DRYRUN_OUT.with_suffix(".estimate.json").write_text(json.dumps({
        "peak": peak, "flops": est.flops, "bytes": est.bytes,
        "launches": est.launches, "s": time.perf_counter() - t}))
    for cell in DRYRUN_CELLS:
        dryrun.run_cell(*cell, str(DRYRUN_OUT.with_suffix(".jsonl")))
    return 0


def start_dryrun_cells() -> subprocess.Popen:
    """Start phase 24's CPU counts at once, beside the card's phases: one
    niced single-threaded process (fake tensors do no arithmetic), its
    output under ``DRYRUN_OUT``; stopped at exit if still running."""
    DRYRUN_OUT.parent.mkdir(parents=True, exist_ok=True)
    for ext in (".jsonl", ".err", ".estimate.json"):
        DRYRUN_OUT.with_suffix(ext).unlink(missing_ok=True)
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    err = open(DRYRUN_OUT.with_suffix(".err"), "w")
    proc = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--dryrun-cells"],
        env=env, stdout=err, stderr=err, preexec_fn=lambda: os.nice(10))
    err.close()

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    atexit.register(stop)
    return proc


def phase_step_roofline(torch, np, configs, elastic, EASGDConfig, train,
                        synthetic, kernels, timing, costmodel, opcount, dev,
                        card, bw, bf16, est: dict) -> dict:
    """Phase 24a: phase 10's cell counted by ``launch.opcount`` on the
    card path, priced on the card's own data-sheet row beside its measured
    warm step; the dry run's peak estimate ``est`` (``dryrun_child``:
    fake tensors on the CPU) against ``max_memory_allocated``; the
    counter's kernel calls against the launch counters and phase 10's
    counts."""
    cfg, ecfg, p, S = phase10_cell(configs, elastic, EASGDConfig)
    est_peak = est["peak"]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    build = train.build_train_step(cfg, ecfg, n_pods=p, per_pod_batch=1,
                                   seq=S, device=dev)
    state = build.init_state()
    shards = [synthetic.SyntheticLMStream(cfg.vocab_size, S, 1, seed=13,
                                          shard=i, n_shards=p).batch_at(0)
              for i in range(p)]
    batch = {k: np.stack([sh[k] for sh in shards]) for k in shards[0]}

    def step():
        # the step updates the state's tensors in place
        return build.step(state, batch)
    step()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with opcount.OpCounter() as counter:
        _, metrics = step()
        torch.cuda.synchronize()
    launched = kernels.launch_counts()
    costs = counter.costs()
    want = lm_counts(cfg, p, updates=1)
    check(launched == want, f"counted step launched {launched}, phase 10 "
          f"counts {want}")
    check(costs.launches == {k: v for k, v in want.items() if v},
          f"the counter's kernel calls {costs.launches} != the launch "
          f"counters {want}")
    check(math.isfinite(metrics["loss"].item()), "counted step loss finite")
    torch.cuda.reset_peak_memory_stats()
    step_ms = timing.cuda_time_ms(step, reps=3, warmup=0)
    peak = torch.cuda.max_memory_allocated() - base
    best_s = timing.time_fn(step, iters=3, warmup=0)
    chip = costmodel.Chip(card, bf16, bw, float(
        torch.cuda.get_device_properties(dev).total_memory),
        costmodel.H100_SXM.link_bandwidth)
    rl = costmodel.roofline(costs.flops, costs.bytes, costs.collective_bytes,
                            1, chip)
    n = state.params.shape[1]
    model_flops = costmodel.model_flops_train(n, p * S)
    frac = 1e3 * rl.bound_s / step_ms
    ratio = est_peak / peak
    kernel_flops = sum(r["operations"] for r in costs.regions.values())
    kernel_bytes = sum(r["bytes"] for r in costs.regions.values())
    print(f"step roofline {cfg.name} {cfg.n_layers} layers n={n} P={p} B=1 "
          f"S={S}: counted on the card path {costs.flops:.6e} FLOPs "
          f"({kernel_flops / costs.flops:.1%} in kernel regions), "
          f"{costs.bytes:.6e} bytes ({kernel_bytes / costs.bytes:.1%} in "
          f"kernel regions), {costs.collective_bytes:.0f} collective bytes; "
          f"on {card}'s data sheet (bf16 {bf16 / 1e12:g} TFLOP/s, "
          f"{bw / 1e12:g} TB/s): compute {1e3 * rl.compute_s:.3f} ms, "
          f"memory {1e3 * rl.memory_s:.3f} ms, collective "
          f"{1e3 * rl.collective_s:.3f} ms, dominant {rl.dominant}, bound "
          f"{1e3 * rl.bound_s:.3f} ms", flush=True)
    print(f"step roofline {cfg.name}: warm step {step_ms:.3f} ms (CUDA "
          f"events, median of 3), {1e3 * best_s:.3f} ms (time_fn, best of "
          f"3); roofline fraction bound / step {frac:.4f}; 6·N·D model "
          f"FLOPs {model_flops:.6e} at the bf16 peak "
          f"{model_flops / bf16 / (step_ms / 1e3):.4f} of the step",
          flush=True)
    print(f"step roofline {cfg.name}: peak estimate {est_peak / 2**30:.3f} "
          f"GiB (fake tensors on the CPU, {est['s']:.1f} s) vs measured "
          f"{peak / 2**30:.3f} GiB (max_memory_allocated above the "
          f"{base / 2**30:.3f} GiB held before the build): estimate / "
          f"measured {ratio:.4f} (limit {PEAK_LIMIT:g}); the CPU count "
          f"{est['flops']:.6e} FLOPs, {est['bytes']:.6e} bytes "
          f"({est['flops'] / costs.flops:.6f}, "
          f"{est['bytes'] / costs.bytes:.6f} of the card path's)",
          flush=True)
    print(f"step roofline {cfg.name}: counter kernel calls {costs.launches} "
          f"== launch counters == phase 10's counts", flush=True)
    check(abs(ratio - 1) <= PEAK_LIMIT,
          f"peak estimate / measured {ratio:.4f} outside {PEAK_LIMIT:g}")
    del state, build
    torch.cuda.empty_cache()
    return launched


def phase_dryrun_cells(proc, wait_s: float = 900.0) -> dict:
    """Phase 24b: the records of ``DRYRUN_CELLS``, counted on this host's
    CPU since the script started; returns phase 24a's estimate."""
    t = time.perf_counter()
    try:
        rc = proc.wait(timeout=wait_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise RuntimeError(f"dry-run cells not done after {wait_s:g} s more")
    waited = time.perf_counter() - t
    err = DRYRUN_OUT.with_suffix(".err").read_text()
    check(rc == 0, f"dry-run cells exit {rc}: {err[-2000:]}")
    recs = [json.loads(line) for line in
            DRYRUN_OUT.with_suffix(".jsonl").read_text().splitlines()]
    check([(r["arch"], r["shape"], r["mesh_kind"]) for r in recs]
          == list(DRYRUN_CELLS), "one record a dry-run cell")
    for r in recs:
        tag = f"dry run {r['arch']} {r['shape']} {r['mesh_kind']}"
        check(r["ok"], f"{tag}: {r.get('error')}")
        rl = r["roofline"]
        mb = r.get("microbatches", 1)
        print(f"{tag} ({r['mesh']}, {mb} microbatches, "
              f"traced in {r['trace_s']:.1f} s on this host's CPU): "
              f"counts priced on {r['chip']}'s data sheet, not times: "
              f"compute {rl['compute_s']:.6f} s, memory "
              f"{rl['memory_s']:.6f} s, collective {rl['collective_s']:.6f} "
              f"s, cross-pod {rl['cross_pod_s']:.6f} s, dominant "
              f"{rl['dominant']}, bound {rl['bound_s']:.6f} s; "
              f"{r['flops_per_device']:.6e} FLOPs, "
              f"{r['bytes_per_device']:.6e} bytes, "
              f"{r['collective_bytes_per_device']} collective bytes a "
              f"device; peak {r['peak_bytes_per_device'] / 2**30:.3f} GiB "
              f"a device (fits: {r['fits_device']}); useful FLOPs "
              f"{r['useful_flops_ratio']:.4f}, roofline fraction "
              f"{r['roofline_fraction']:.4f}", flush=True)
        check(r["fits_device"], f"{tag} fits the device")
    print(f"dry-run cells: waited {waited:.1f} s for them here", flush=True)
    return json.loads(DRYRUN_OUT.with_suffix(".estimate.json").read_text())


def phase_elastic_restart(device="cuda") -> None:
    """Phase 24c: ``examples/elastic_restart_torch.py`` on the card."""
    t = time.perf_counter()
    out = subprocess.run(
        [sys.executable, str(SRC.parent / "examples" /
                             "elastic_restart_torch.py"),
         "--device", device],
        env=dict(os.environ, PYTHONPATH=str(SRC)), capture_output=True,
        text=True, timeout=600)
    for line in out.stdout.strip().splitlines():
        print(f"  elastic_restart_torch: {line}")
    check(out.returncode == 0, f"elastic_restart_torch.py --device {device} "
          f"exit {out.returncode}: {out.stderr[-2000:]}")
    print(f"examples/elastic_restart_torch.py --device {device}: exit 0 in "
          f"{time.perf_counter() - t:.1f} s", flush=True)


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
    from repro_torch.comm import schedules as comm_schedules
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
    from repro_torch.launch import opcount
    from repro_torch.launch import train as launcher
    from repro_torch.net import peer, server, wire
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
    dry = start_dryrun_cells()
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
                     timing, dev, flat_row=True)
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
    phase_async_alexnet(torch, runtime, zoo, kernels, EASGDConfig,
                        async_engine)
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

    # topology-aware scale-out and the jax-mlp problem (phase 19)
    release_card(torch, "before phase 19")
    t = time.perf_counter()
    add_counts(launches, phase_topology_thread(
        torch, runtime, problems, kernels, costmodel, comm_rounds,
        comm_schedules, EASGDConfig))
    print(f"phase 19a-b: {time.perf_counter() - t:.1f} s", flush=True)
    t19 = time.perf_counter()
    add_counts(launches, phase_topology_tcp(
        torch, runtime, problems, kernels, costmodel, comm_schedules, peer,
        EASGDConfig))
    print(f"phase 19c: {time.perf_counter() - t19:.1f} s", flush=True)
    t19 = time.perf_counter()
    add_counts(launches, phase_topology_alexnet(
        torch, runtime, zoo, kernels, costmodel, comm_rounds, comm_schedules,
        peer, wire, EASGDConfig))
    print(f"phase 19d: {time.perf_counter() - t19:.1f} s", flush=True)
    t19 = time.perf_counter()
    add_counts(launches, phase_topology_entry_points(
        torch, runtime, problems, zoo, kernels, EASGDConfig))
    print(f"phase 19e: {time.perf_counter() - t19:.1f} s", flush=True)
    print(f"phase topology (19): {time.perf_counter() - t:.1f} s", flush=True)

    # per-slot remat and six more model families (phase 20)
    release_card(torch, "before phase 20")
    t = time.perf_counter()
    for arch, layers in REMAT_CASES:
        phase_remat(torch, np, dataclasses.replace(
            configs.get(arch).config, n_layers=layers), 4096, tfm, common,
            kernels, timing, dev)
    print(f"phase 20a: {time.perf_counter() - t:.1f} s", flush=True)
    t20 = time.perf_counter()
    phase_families(torch, np, configs, tfm, common, fa, ce, kernels, timing,
                   dev)
    print(f"phase 20b: {time.perf_counter() - t20:.1f} s", flush=True)
    t20 = time.perf_counter()
    merge_rows(rows, phase_attention(torch, F, fa, timing, dev, bw, bf16,
                                     cases=ATTN_D96_CASES, tag_timed="_d96"))
    merge_rows(rows, phase_attention(torch, F, fa, timing, dev, bw, bf16,
                                     cases=ATTN_D24_CASES, tag_timed="_d24"))
    print(f"phase 20c: {time.perf_counter() - t20:.1f} s", flush=True)
    t20 = time.perf_counter()
    hybrid = dataclasses.replace(configs.get("recurrentgemma-2b").config,
                                 n_layers=8)
    check(tfm.n_params(hybrid) == N_RECURRENTGEMMA_8L,
          "recurrentgemma-2b at 8 layers")
    multi, counts = phase_multi_pod(torch, np, hybrid, 4096, elastic,
                                    EASGDConfig, train, synthetic, eu,
                                    kernels, timing, dev, bw, f32)
    add_counts(launches, counts)
    rows["fused_elastic_update"].update(
        ms_in_step_recurrentgemma=multi["update_ms"],
        bound_ms_in_step_recurrentgemma=multi["update_bound_ms"])
    print(f"phase 20d: {time.perf_counter() - t20:.1f} s", flush=True)
    t20 = time.perf_counter()
    add_counts(launches, phase_family_launchers(
        torch, np, configs, elastic, EASGDConfig, train, launcher, kernels,
        dev, [arch for arch, _, _ in FAMILIES]))
    add_counts(launches, phase_ps_model(launcher, kernels, configs))
    print(f"phase 20e: {time.perf_counter() - t20:.1f} s", flush=True)
    print(f"phase families (20): {time.perf_counter() - t:.1f} s", flush=True)

    # the MoE and MLA families (phase 21)
    release_card(torch, "before phase 21")
    t = time.perf_counter()
    merge_rows(rows, phase_attention(torch, F, fa, timing, dev, bw, bf16,
                                     cases=ATTN_MLA_CASES, tag_timed="_mla"))
    print(f"phase 21a: {time.perf_counter() - t:.1f} s", flush=True)
    t21 = time.perf_counter()
    phase_moe_families(torch, np, configs, tfm, common, fa, ce, kernels,
                       timing, dev)
    print(f"phase 21b: {time.perf_counter() - t21:.1f} s", flush=True)
    t21 = time.perf_counter()
    moe_ids = [arch for arch, _, _ in MOE_FAMILIES]
    add_counts(launches, phase_family_launchers(
        torch, np, configs, elastic, EASGDConfig, train, launcher, kernels,
        dev, moe_ids))
    for arch in moe_ids:
        add_counts(launches, phase_ps_model(launcher, kernels, configs,
                                            arch=arch))
    print(f"phase 21c: {time.perf_counter() - t21:.1f} s", flush=True)
    print(f"phase moe families (21): {time.perf_counter() - t:.1f} s",
          flush=True)

    # serving: prefill and decode with caches (phase 22)
    release_card(torch, "before phase 22")
    t = time.perf_counter()
    counts, serve_rows = phase_serving(torch, np, configs, tfm, common, fa,
                                       sc, kernels, timing, dev, bw)
    add_counts(launches, counts)
    merge_rows(rows, serve_rows)
    print(f"phase serving (22): {time.perf_counter() - t:.1f} s", flush=True)

    # multi-device placement on a world of one (phase 23)
    release_card(torch, "before phase 23")
    t = time.perf_counter()
    add_counts(launches, phase_mesh(torch, full, 4096, elastic, EASGDConfig,
                                    train, synthetic, kernels, timing, dev))
    print(f"phase mesh (23): {time.perf_counter() - t:.1f} s", flush=True)

    # the tooling: the whole step counted and priced (phase 24); the CPU's
    # counts (24b and 24a's estimate) have run since the script started
    release_card(torch, "before phase 24")
    t = time.perf_counter()
    est = phase_dryrun_cells(dry)
    print(f"phase 24b: {time.perf_counter() - t:.1f} s", flush=True)
    t24 = time.perf_counter()
    add_counts(launches, phase_step_roofline(
        torch, np, configs, elastic, EASGDConfig, train, synthetic, kernels,
        timing, costmodel, opcount, dev, card, bw, bf16, est))
    print(f"phase 24a: {time.perf_counter() - t24:.1f} s", flush=True)
    t24 = time.perf_counter()
    phase_elastic_restart()
    print(f"phase 24c: {time.perf_counter() - t24:.1f} s", flush=True)
    print(f"phase tooling (24): {time.perf_counter() - t:.1f} s", flush=True)

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
    sys.exit(dryrun_child() if sys.argv[1:] == ["--dryrun-cells"]
             else main())

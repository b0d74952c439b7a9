"""Multi-pod dry run: trace one step of every (arch × shape × mesh) cell on
a fake world and price its work on the H100's data sheet (the port of
``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-4b \\
        --shape train_4k --mesh pod --out results/dryrun_torch.jsonl
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \
        --jobs 4

The reference lowers and compiles each cell for 256 or 512 devices and
reads the compiled program. The port has no compiler to ask: each cell
runs in one CPU process that joins a fake world of 256 or 512 ranks
(``torch.testing._internal.distributed.fake_pg``: every collective
returns at once), builds the production mesh (``launch.mesh``), builds
``runtime.train.build_train_step`` or ``runtime.serve.build_serve_steps``
at the full config and ``configs.SHAPES``, and runs one step of rank 0 on
fake tensors (``FakeTensorMode``: shapes and dtypes, no storage) under

* ``launch.opcount.OpCounter``: the FLOPs, bytes and collective bytes per
  device, each kernel region counted by its formula;
* ``torch.distributed._tools.mem_tracker.MemTracker``: the peak bytes per
  device, the step's state included.

Every number in a record is a count of rank 0's step priced on
``costmodel.H100_SXM``, not a time taken. A cell the port cannot place
(a layer kind ``runtime.sharding`` does not place, a cache split over
its time dim) is recorded ``ok: false`` with its error.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import json
import os
import subprocess
import sys
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.core import compression as compression_lib
from repro_torch.core import costmodel, elastic
from repro_torch.core.easgd import EASGDConfig
from repro_torch.core.elastic import ElasticConfig
from repro_torch.launch import opcount
from repro_torch.launch.mesh import axis_sizes, make_production_mesh
from repro_torch.models import transformer as tfm
from repro_torch.models.common import (spec_leaves, tree_leaves_with_path,
                                       tree_unflatten)
from repro_torch.runtime import serve
from repro_torch.runtime import sharding as shd
from repro_torch.runtime.train import build_train_step, make_batch_defs

CPU = torch.device("cpu")


def count_params(cfg) -> tuple:
    """(total, active) parameter counts from the model's defs: an expert
    leaf counts top_k / n_experts of its size as active."""
    total = active = 0
    for _, d in tree_leaves_with_path(tfm.model_defs(cfg)):
        n = 1
        for s in d.shape:
            n *= s
        total += n
        if cfg.moe is not None and "experts" in d.logical:
            active += n * cfg.moe.top_k / cfg.moe.n_experts
        else:
            active += n
    return int(total), int(active)


def make_elastic_config(spec, *, overrides=None) -> ElasticConfig:
    kw = dict(easgd=EASGDConfig(eta=0.01, rho=0.01, mu=0.9, tau=1),
              mode="sync_easgd", packed=True, overlap=True,
              momentum_dtype=spec.momentum_dtype,
              center_dtype=spec.center_dtype)
    kw.update(overrides or {})
    return ElasticConfig(**kw)


@contextlib.contextmanager
def fake_world(world: int):
    """This process as rank 0 of a fake world of ``world`` ranks."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group exists: the dry run needs a "
                           "process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _fake(defs: dict) -> dict:
    """``{name: (shape, dtype)}`` -> zero tensors (fake under the mode)."""
    return {k: torch.zeros(s, dtype=dt) for k, (s, dt) in defs.items()}


def _tensors(*trees) -> list:
    out = []
    for tree in trees:
        for _, leaf in tree_leaves_with_path(tree):
            if isinstance(leaf, torch.Tensor):
                out.append(leaf)
    return out


def _local_params(cfg, mesh=None) -> dict:
    """This rank's shards of the f32 master params (all of them without a
    mesh), as zeros: a fake tensor has no values, and the count does not
    depend on them."""
    defs = tfm.model_defs(cfg)
    leaves = [d for _, d in tree_leaves_with_path(defs)]
    if mesh is None:
        shapes = [d.shape for d in leaves]
    else:
        sizes = axis_sizes(mesh)
        shapes = [shd.local_shape(d.shape, s, sizes) for d, s in
                  zip(leaves, spec_leaves(shd.param_specs(cfg, mesh)))]
    return tree_unflatten(defs, [torch.zeros(s, dtype=cfg.param_dtype)
                                 for s in shapes])


def train_step(cfg, ecfg, *, n_pods: int, per_pod_batch: int, seq: int,
               microbatches: int = 1, mesh=None, device=CPU) -> tuple:
    """``(run, held)``: one ``build_train_step`` step of this rank on the
    state ``init_state`` would make (its local pods and shards, zeros)
    and a zero batch, and the tensors it holds before it runs."""
    build = build_train_step(cfg, ecfg, n_pods=n_pods,
                             per_pod_batch=per_pod_batch, seq=seq,
                             microbatches=microbatches, device=device,
                             mesh=mesh)
    pods = n_pods // (axis_sizes(mesh).get("pod", 1) if mesh else 1)
    state = elastic.init(_local_params(cfg, mesh), ecfg, pods)
    batch = _fake(make_batch_defs(cfg, n_pods, per_pod_batch, seq))
    held = [state.params, state.momentum, state.center, state.ef_error,
            *batch.values()]
    return (lambda: build.step(state, batch)), held


def count_step(prepare, *, pod_stride: int = 0, fake: bool = True) -> tuple:
    """``prepare() -> (run, held)``, then one ``run()`` counted (kernel
    regions standing in for the kernels) with its memory tracked from the
    ``held`` tensors on: returns ``(OpCosts, peak bytes)``. ``fake``: on
    fake tensors (else on real CPU tensors: the same counts)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    mode = FakeTensorMode(allow_non_fake_inputs=True) if fake \
        else contextlib.nullcontext()
    with mode:
        run, held = prepare()
        tracker = MemTracker()
        tracker.track_external(*[t for t in held if t is not None])
        del held
        with tracker, opcount.OpCounter(pod_stride=pod_stride,
                                        stand_ins=True) as counter:
            run()
        peak = max(snap["Total"] for snap in
                   tracker.get_tracker_snapshot("peak").values())
    return counter.costs(), int(peak)


def _extras(cfg, B, S) -> dict:
    return {k: torch.zeros(d.shape, dtype=d.dtype)
            for k, d in serve._extra_kwargs(cfg, B, S).items()}


def _prepare(arch_id, shape_id, mesh, spec, cfg, elastic_overrides,
             microbatches_override, shape):
    """Build the cell's step: ``(run, held, meta, ecfg)``, where ``run()``
    is one step and ``held`` the tensors it holds before it runs."""
    sizes = axis_sizes(mesh)
    n_pods = sizes.get("pod", 1)
    b, seq = shape["global_batch"], shape["seq"]
    meta = dict(arch=arch_id, shape=shape_id,
                mesh="x".join(str(v) for v in sizes.values()),
                n_devices=int(mesh.mesh.numel()), n_pods=n_pods)
    if shape["kind"] == "train":
        ecfg = make_elastic_config(spec, overrides=elastic_overrides)
        per_pod = b // n_pods
        dsz = sizes.get("data", 1)
        # the per-microbatch batch must still divide the data axis
        mb = microbatches_override or spec.train_microbatches
        while mb > 1 and (per_pod % mb or (per_pod // mb) % dsz):
            mb //= 2
        run, held = train_step(cfg, ecfg, n_pods=n_pods,
                               per_pod_batch=per_pod, seq=seq,
                               microbatches=mb, mesh=mesh)
        meta.update(microbatches=mb, tokens=b * seq, step="train_step")
        return run, held, meta, ecfg
    build = serve.build_serve_steps(cfg, batch=b, max_len=seq, device=CPU,
                                    mesh=mesh)
    params = tfm.cast_for_serving(cfg, _local_params(cfg, mesh))
    if shape["kind"] == "prefill":
        tokens = torch.zeros((b, seq), dtype=torch.int64)
        extras = _extras(cfg, b, seq)
        meta.update(tokens=b * seq, step="prefill")
        held = _tensors(params) + [tokens, *extras.values()]
        return (lambda: build.prefill(params, tokens, extras)), held, meta, \
            None
    cspecs = build.cache_spec_tree
    caches = tree_unflatten(build.abstract_caches, [
        torch.zeros(shd.local_shape(d.shape, s, sizes), dtype=d.dtype)
        for (_, d), s in zip(tree_leaves_with_path(build.abstract_caches),
                             spec_leaves(cspecs))])
    token = torch.zeros((b, 1), dtype=torch.int64)
    pos = torch.full((b,), seq // 2, dtype=torch.int64)
    extras = _extras(cfg, b, 1)
    meta.update(tokens=b, step="decode_step")
    held = _tensors(params, caches) + [token, pos, *extras.values()]
    return (lambda: build.decode(params, caches, token, pos, extras)), \
        held, meta, None


def trace_cell(arch_id: str, shape_id: str, mesh, *, elastic_overrides=None,
               cfg_override=None, microbatches_override=None):
    """One step of rank 0 of the cell on fake tensors, counted: returns
    ``(OpCosts, peak bytes per device, meta, cfg, ecfg)``."""
    spec = configs.get(arch_id)
    cfg = cfg_override or spec.config
    sizes = axis_sizes(mesh)
    pod_stride = (int(mesh.mesh.numel()) // sizes["pod"]
                  if sizes.get("pod", 1) > 1 else 0)
    found = {}

    def prepare():
        run, held, found["meta"], found["ecfg"] = _prepare(
            arch_id, shape_id, mesh, spec, cfg, elastic_overrides,
            microbatches_override, configs.SHAPES[shape_id])
        return run, held

    costs, peak = count_step(prepare, pod_stride=pod_stride)
    return costs, peak, found["meta"], cfg, found["ecfg"]


def analyze(costs, peak: int, meta: dict, cfg, chips: int, ecfg=None,
            chip: costmodel.Chip = costmodel.H100_SXM) -> dict:
    """The record of one counted cell: the reference's keys where the
    meaning is the same, priced on ``chip``."""
    rec = dict(meta)
    rec["peak_bytes_per_device"] = peak
    rec["fits_device"] = bool(peak < chip.hbm_bytes)
    rec["chip"] = chip.name
    rec["flops_per_device"] = float(costs.flops)
    rec["bytes_per_device"] = float(costs.bytes)
    rec["collective_bytes_by_type"] = costs.bytes_by_collective
    rec["collective_counts"] = costs.counts_by_collective
    rec["collective_bytes_per_device"] = int(costs.collective_bytes)
    rec["cross_pod_bytes_per_device"] = int(costs.cross_pod_bytes)
    rec["collective_bytes_by_dtype"] = costs.collective_bytes_by_dtype
    rec["cross_pod_bytes_by_dtype"] = costs.cross_pod_bytes_by_dtype
    rec["kernel_regions"] = costs.regions

    n_total, n_active = count_params(cfg)
    rec["n_params"] = n_total
    rec["n_params_active"] = n_active
    rec["param_bytes"] = int(n_total * cfg.param_dtype.itemsize)
    flops_fn = (costmodel.model_flops_train if meta["step"] == "train_step"
                else costmodel.model_flops_infer)
    rec["model_flops"] = flops_fn(n_active, meta["tokens"])

    flops = costs.flops * chips
    rl = costmodel.roofline(flops, costs.bytes * chips,
                            costs.collective_bytes * chips, chips, chip)
    rec["roofline"] = dict(
        compute_s=rl.compute_s, memory_s=rl.memory_s,
        collective_s=rl.collective_s, dominant=rl.dominant,
        bound_s=rl.bound_s,
        # the cross-pod part over the reference's pod network
        cross_pod_s=costs.cross_pod_bytes * costmodel.POD_EXCHANGE_NET.beta)
    rec["useful_flops_ratio"] = rec["model_flops"] / flops if flops else 0.0

    if ecfg is not None:
        comp = compression_lib.get(ecfg.compression)
        n_pods = max(int(meta.get("n_pods", 1)), 1)
        shard_elems = -(-n_total // (chips // n_pods))
        model_bytes = shard_elems * comp.jit_wire_bytes_per_element
        counted = int(costs.cross_pod_bytes)
        rec["wire_model"] = {
            "compression": comp.name,
            "jit_bytes_per_element": comp.jit_wire_bytes_per_element,
            "framed_bytes_per_element": comp.wire_bytes_per_element,
            "cross_pod_model_bytes_per_device": model_bytes,
            "cross_pod_counted_bytes_per_device": counted,
            "counted_over_model": (counted / model_bytes if model_bytes
                                   else None),
            "auto_schedule_choice": ecfg.resolve_schedule(n_pods, n_total),
        }
    ideal_s = rec["model_flops"] / (chips * chip.peak_flops)
    rec["roofline_fraction"] = ideal_s / rl.bound_s if rl.bound_s else 0.0
    return rec


def run_cell(arch_id, shape_id, mesh_kind, out_path=None,
             elastic_overrides=None, variant="baseline", cfg_override=None,
             microbatches_override=None) -> dict:
    """Trace and analyse one cell in a fake world of its own; a failure
    is recorded, not raised."""
    chips = 512 if mesh_kind == "multipod" else 256
    t0 = time.time()
    rec = dict(arch=arch_id, shape=shape_id, mesh_kind=mesh_kind,
               variant=variant)
    try:
        with fake_world(chips):
            mesh = make_production_mesh(multi_pod=(mesh_kind == "multipod"),
                                        device=CPU)
            costs, peak, meta, cfg, ecfg = trace_cell(
                arch_id, shape_id, mesh,
                elastic_overrides=elastic_overrides,
                cfg_override=cfg_override,
                microbatches_override=microbatches_override)
            rec["trace_s"] = time.time() - t0
            rec.update(analyze(costs, peak, meta, cfg, chips, ecfg=ecfg))
        rec["ok"] = True
    except Exception as e:
        rec["ok"] = False
        rec["error"] = repr(e)
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["total_s"] = time.time() - t0
    if out_path:
        with open(out_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
    return rec


def summary_line(rec: dict) -> str:
    if not rec["ok"]:
        return f"  FAIL {rec['error'][:300]}"
    rl = rec["roofline"]
    return (f"  ok  trace={rec['trace_s']:.0f}s "
            f"peak={rec['peak_bytes_per_device'] / 2**30:.2f}GiB "
            f"dom={rl['dominant']} terms=({rl['compute_s']:.2e},"
            f"{rl['memory_s']:.2e},{rl['collective_s']:.2e})s "
            f"frac={rec['roofline_fraction']:.2f} (counts priced on "
            f"{rec['chip']})")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--schedule", default=None,
                    help="override the cross-pod exchange schedule "
                         "(repro_torch.comm registry name)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch.jsonl")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, each in a process of its "
                         "own (default 1: in this process, one by one)")
    args = ap.parse_args(argv)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    done = set()
    if args.skip_done and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if r.get("ok"):
                    done.add((r["arch"], r["shape"], r["mesh_kind"]))

    if args.all:
        cells = [(a, s) for a, s, ok in configs.cells() if ok]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("give --arch and --shape, or --all")
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    todo, ran = [], {mk: 0 for mk in meshes}
    for aid, shape_id in cells:
        for mk in meshes:
            if (aid, shape_id, mk) in done:
                print(f"SKIP {aid} {shape_id} {mk} (done)", flush=True)
                ran[mk] += 1
            else:
                todo.append((aid, shape_id, mk))

    def one(cell):
        aid, shape_id, mk = cell
        if args.jobs == 1:
            rec = run_cell(aid, shape_id, mk, args.out,
                           elastic_overrides=overrides)
            return cell, rec["ok"], summary_line(rec)
        # a process a cell: each joins its own fake world
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               aid, "--shape", shape_id, "--mesh", mk, "--out", args.out]
        if args.schedule:
            cmd += ["--schedule", args.schedule]
        out = subprocess.run(cmd, capture_output=True, text=True)
        lines = out.stdout.strip().splitlines()
        ok = out.returncode == 0 and bool(lines) and \
            lines[-1].startswith("  ok")
        return cell, ok, (lines[-1] if lines else
                          f"  FAIL exit {out.returncode}: {out.stderr[-300:]}")

    overrides = {"schedule": args.schedule} if args.schedule else None
    with concurrent.futures.ThreadPoolExecutor(args.jobs) as pool:
        for (aid, shape_id, mk), ok, line in pool.map(one, todo):
            print(f"=== {aid} × {shape_id} × {mk} ===\n{line}", flush=True)
            ran[mk] += ok
    if args.all:
        for mk in meshes:
            print(f"{mk}: {ran[mk]} of {len(cells)} supported cells ran",
                  flush=True)

if __name__ == "__main__":
    main()

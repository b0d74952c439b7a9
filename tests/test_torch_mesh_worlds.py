"""Worlds of gloo processes on the CPU for tests/test_torch_mesh*.py: each
rank joins a process group over a ``FileStore``, runs one of the functions
below on a mesh of the port and writes what it returns to a file. This
module imports only torch, numpy and the port, so a rank starts in about
two seconds.

    world = World(8, "train_world", payload, tmp_dir)   # starts the ranks
    outs = world.results()                              # joins them
"""
from __future__ import annotations

import dataclasses
import datetime
import faulthandler
import multiprocessing as mp
import os
import traceback
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.core import elastic
from repro_torch.core.easgd import EASGDConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer as tfm
from repro_torch.runtime import serve, train

JOIN_S = 240
_FAULTS = None    # the rank's faulthandler file, open until it exits


def _fault_log(out_dir, name, rank) -> str:
    return os.path.join(out_dir, f"{name}-{rank}.faults")


def _run(rank, world, store, name, payload, out_dir):
    # a native crash writes the Python frames of every thread here, which
    # World.results prints beside the rank's exit code
    global _FAULTS
    _FAULTS = open(_fault_log(out_dir, name, rank), "w")
    faulthandler.enable(_FAULTS, all_threads=True)
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=JOIN_S - 30))
    try:
        out = globals()[name](payload)
    except BaseException:
        out = {"error": traceback.format_exc()}
    torch.save(out, os.path.join(out_dir, f"{name}-{rank}.pt"))
    # no rank tears its gloo pairs down while another still sends on them
    dist.barrier()
    dist.destroy_process_group()


class World:
    """``n`` spawned ranks running ``name(payload)``."""

    def __init__(self, n: int, name: str, payload, out_dir):
        self.n, self.name, self.dir = n, name, str(out_dir)
        store = os.path.join(self.dir, f"{name}.store")
        ctx = mp.get_context("spawn")
        self.procs = [ctx.Process(target=_run, args=(r, n, store, name,
                                                     payload, self.dir))
                      for r in range(n)]
        for p in self.procs:
            p.start()
        self._out = None

    def results(self) -> list:
        if self._out is None:
            for p in self.procs:
                p.join(JOIN_S)
            self.close()
            codes = [p.exitcode for p in self.procs]
            faults = ""
            for r, code in enumerate(codes):
                if code != 0:
                    with open(_fault_log(self.dir, self.name, r)) as f:
                        faults += f"--- rank {r} exit {code}:\n{f.read()}"
            assert codes == [0] * self.n, \
                f"{self.name} exit codes {codes}\n{faults}"
            self._out = [torch.load(os.path.join(self.dir,
                                                 f"{self.name}-{r}.pt"),
                                    weights_only=False)
                         for r in range(self.n)]
            errors = [o["error"] for o in self._out if "error" in o]
            assert not errors, errors[0]
        return self._out

    def close(self):
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join()


def _cfg(compute: str, **kw):
    return dataclasses.replace(configs.get("gemma3-4b").reduced,
                               compute_dtype=getattr(torch, compute), **kw)


def train_world(payload) -> dict:
    """``steps`` packed multi-pod steps on one batch on a ``(pod, data,
    model)`` mesh from the reference's initial state, per case; every
    rank returns the gathered state's leaves and the last step's
    metrics."""
    mesh = mesh_lib.make_host_mesh(*payload["shape"], device="cpu")
    out = {}
    for case in payload["cases"]:
        cfg = _cfg(case["compute"], fsdp=case.get("fsdp", False))
        ecfg = elastic.ElasticConfig(
            easgd=EASGDConfig(**payload["easgd"]), packed=True,
            schedule=case.get("schedule", "psum"),
            compression=case.get("compression", "none"),
            overlap=case.get("overlap", True))
        build = train.build_train_step(
            cfg, ecfg, n_pods=payload["n_pods"],
            per_pod_batch=payload["batch"], seq=payload["seq"],
            microbatches=payload["microbatches"], device="cpu", mesh=mesh)
        state = elastic.state_from_jax(payload["state"], device="cpu",
                                       mesh=mesh,
                                       param_specs=build.param_specs)
        if ecfg.compression != "none":
            state = dataclasses.replace(
                state, ef_error=torch.zeros_like(state.params))
        for _ in range(payload["steps"]):
            state, metrics = build.step(state, payload["batch_arrays"])
        full = elastic.gather_state(state, mesh, build.param_specs)
        out[case["name"]] = {
            "leaves": elastic.state_leaves(full),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "local_shape": tuple(state.params.shape)}
    return out


def serve_world(payload) -> dict:
    """Prefill and one greedy decode step on a ``(data, model)`` mesh from
    the reference's params; then the layer kinds that do not run on the
    mesh, each of whose builds must raise ``NotImplementedError``."""
    d, m = payload["shape"]
    mesh = mesh_lib.make_host_mesh(d, m, device="cpu")
    cfg = _cfg("float32")
    B, L = payload["B"], payload["L"]
    build = serve.build_serve_steps(cfg, batch=B, max_len=L, device="cpu",
                                    mesh=mesh)
    params, _ = tfm.params_from_jax(payload["params"], cfg, device="cpu")
    p = build.cast_params(params)
    toks = torch.from_numpy(payload["tokens"]).long()
    logits, caches = build.prefill(p, toks, {})
    tok = torch.argmax(logits, -1)[:, None]
    pos = torch.full((B,), L - 4, dtype=torch.int64)
    logits2, caches = build.decode(p, caches, tok, pos, {})
    raised = {}
    ecfg = elastic.ElasticConfig(easgd=EASGDConfig(**payload["easgd"]))
    for arch in payload["other_archs"]:
        rc = configs.get(arch).reduced
        for what, fn in (
                ("train", lambda: train.build_train_step(
                    rc, ecfg, n_pods=1, per_pod_batch=2, seq=8,
                    device="cpu", mesh=mesh)),
                ("serve", lambda: serve.build_serve_steps(
                    rc, batch=2, max_len=8, device="cpu", mesh=mesh))):
            try:
                fn()
                raised[(arch, what)] = None
            except NotImplementedError as e:
                raised[(arch, what)] = str(e)
    return {"logits": logits.numpy(), "logits2": logits2.numpy(),
            "tok": tok.numpy(), "raised": raised,
            "cache_shape": tuple(caches["stacked"][0]["k"].shape),
            "specs": (build.token_spec, build.cache_spec_tree is not None)}


class RefState(NamedTuple):
    """A reference ``ElasticState`` with numpy leaves (picklable without
    the reference)."""
    step: object
    params: object
    momentum: object
    center: object
    ef_error: object


def np_tree(tree):
    """A pytree of dicts / tuples with numpy leaves; a reference
    ``ElasticState`` becomes a ``RefState``."""
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return RefState(*[np_tree(v) for v in tree])
    if isinstance(tree, (tuple, list)):
        return tuple(np_tree(v) for v in tree)
    return None if tree is None else np.asarray(tree)


def variants_world(payload) -> dict:
    """The placement's branches on a ``(pod 2, data 2, model 2)`` mesh,
    each held against the port's own un-meshed step (every rank runs it
    whole): 2 steps per case, the gathered meshed state against the
    un-meshed one. Rank 0 returns the largest differences."""
    mesh = mesh_lib.make_host_mesh(2, 2, n_pods=2, device="cpu")
    base = configs.get("gemma3-4b").reduced
    out = {}
    for case in payload["cases"]:
        cfg = dataclasses.replace(base, compute_dtype=torch.float32,
                                  **case.get("cfg", {}))
        ecfg = elastic.ElasticConfig(
            easgd=EASGDConfig(**payload["easgd"], tau=case.get("tau", 1)),
            **case.get("ecfg", {}))
        kw = dict(n_pods=2, per_pod_batch=4, seq=16,
                  microbatches=case.get("microbatches", 1), device="cpu")
        meshed = train.build_train_step(cfg, ecfg, mesh=mesh, **kw)
        plain = train.build_train_step(cfg, ecfg, **kw)
        s1, s0 = meshed.init_state(), plain.init_state()
        rng = np.random.default_rng(11)
        err = {}
        for step in range(2):
            tokens = rng.integers(0, cfg.vocab_size, (2, 4, 16))
            batch = {"tokens": tokens.astype(np.int32),
                     "targets": np.roll(tokens, -1, -1).astype(np.int32),
                     "mask": (rng.random((2, 4, 16)) > 0.1).astype(
                         np.float32)}
            s1, m1 = meshed.step(s1, batch)
            s0, m0 = plain.step(s0, batch)
            full = elastic.gather_state(s1, mesh, meshed.param_specs)
            for k in ("params", "momentum", "center", "ef_error"):
                a, b = getattr(full, k), getattr(s0, k)
                if a is not None:
                    err[k] = max(err.get(k, 0.0),
                                 float((a.float() - b.float()).abs().max()))
            err["loss"] = max(err.get("loss", 0.0),
                              abs(float(m1["loss"]) - float(m0["loss"])))
            err["tokens"] = max(err.get("tokens", 0.0), abs(
                float(m1["tokens"]) - float(m0["tokens"])))
        out[case["name"]] = {"err": err, "shapes": full.shapes == s0.shapes,
                             "local": tuple(s1.params.shape)}
    return out


def kernels_world(payload) -> dict:
    """Kernels and collectives under placement on a world of 4: the
    vocab-parallel cross-entropy over a model group of 2 against the
    whole vocabulary (with an argmax tied across the two shards), the
    ring all-reduce over groups of 2 and 4, and a schedule that no
    process group runs."""
    from repro_torch.comm import plan as comm_plan
    from repro_torch.kernels import fused_ce
    from repro_torch.models import tp
    rank = dist.get_rank()
    model = dist.new_group([0, 1]), dist.new_group([2, 3])
    group = model[rank // 2]
    m = rank % 2
    g = torch.Generator().manual_seed(3)
    T, d, V = 24, 16, 40
    h = torch.randn(T, d, generator=g)
    w = torch.randn(d, V, generator=g)
    w[:, 25] = w[:, 5]                      # a tie across the shards
    h[0] = w[:, 5] * 4.0                    # token 0's argmax: 5 == 25
    y = torch.randint(0, V, (T,), generator=g)
    y[:3] = torch.tensor([0, V // 2, V - 1])
    loss_w, lse_w, pred_w = fused_ce.fused_ce_fwd_ref(h, w, y)
    up = torch.randn(T, generator=g)
    dh_w, dw_w = fused_ce.fused_ce_bwd_ref(h, w, y, lse_w, up)
    hl = h.clone().requires_grad_(True)
    wl = w[:, m * V // 2:(m + 1) * V // 2].clone().requires_grad_(True)
    lay = tp.Layout(model_group=group, model_size=2, model_rank=m,
                    data_group=None, data_size=1, heads=False,
                    kv_heads=False, ff=False, vocab=True, n_heads=1,
                    n_kv_heads=1, vocab_size=V)
    loss, pred = fused_ce.vocab_parallel_cross_entropy(
        tp.copy_in(hl, lay), wl, y, lay.vocab_start, group)
    (loss * up).sum().backward()
    out = {"loss": float((loss.detach() - loss_w).abs().max()),
           "pred": bool(torch.equal(pred, pred_w)), "pred0": int(pred[0]),
           "dh": float((hl.grad - dh_w).abs().max()),
           "dw": float((wl.grad - dw_w[:, m * V // 2:(m + 1) * V // 2])
                       .abs().max())}
    # the ring schedule's rounds over groups of 2 and 4
    everyone = dist.new_group([0, 1, 2, 3])
    for name, grp, members in (("ring2", group, 2), ("ring4", everyone, 4)):
        x = torch.randn(2, 1001, generator=torch.Generator().manual_seed(
            rank))
        plan = comm_plan.make_plan("ring", n_total=2 * members, group=grp)
        mean, _ = plan.reduce_mean_flat(x)
        want = x.sum(0)
        dist.all_reduce(want, group=grp)
        out[name] = float((mean - want / (2 * members)).abs().max())
    try:
        comm_plan.make_plan("butterfly", n_total=4, group=everyone)
        out["butterfly"] = None
    except NotImplementedError as e:
        out["butterfly"] = str(e)
    return out


def launcher_world(payload) -> dict:
    """``launch.train --mode sync`` on this world's mesh: 6 steps straight,
    then 4 steps that checkpoint (whole tensors from rank 0) and a run
    that resumes them to step 6."""
    from repro_torch.launch import train as launcher
    args = ["--arch", "gemma3-4b", "--reduced", "--n-pods", "2", "--batch",
            "8", "--seq", "16", "--device", "cpu", "--log-every", "100"]
    straight = launcher.main(args + ["--steps", "6"])
    ckpt = ["--ckpt-dir", payload["ckpt_dir"], "--ckpt-every", "2"]
    first = launcher.main(args + ["--steps", "4"] + ckpt)
    resumed = launcher.main(args + ["--steps", "6"] + ckpt)
    return {"straight": straight, "first": first, "resumed": resumed}


def hold_world(payload) -> dict:
    """``chip_smoke.py``'s phase 23 hold on the CPU: reduced gemma3-4b at
    bf16 compute, phase 10's exchange, 2 steps of 2 pods (B 1, S 32)
    meshed as ``model`` 2 and as ``pod`` 2, each rank's ``held_sums``
    against the same steps without a mesh (every rank runs them whole).
    ``fault`` leaves out the model-parallel gradient's all-reduce
    (``copy_in``) or the pod sum (``pod_sum``). Every rank returns its
    sums per world."""
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs
    from repro_torch.comm import plan as comm_plan
    from repro_torch.data import synthetic
    from repro_torch.models import tp
    if payload["fault"] == "copy_in":
        tp._CopyIn.backward = staticmethod(lambda ctx, g: (g, None))
    if payload["fault"] == "pod_sum":
        whole = comm_plan.ExchangePlan._sum

        def local_sum(self, rows):
            if self.group is None:
                return whole(self, rows)
            return rows.sum(0, dtype=rows.dtype), None
        comm_plan.ExchangePlan._sum = local_sum
    cfg = configs.get("gemma3-4b").reduced
    ecfg = cs.mesh_easgd(elastic, EASGDConfig)
    S = 32
    streams = [synthetic.SyntheticLMStream(cfg.vocab_size, S, 1, seed=13,
                                           shard=i, n_shards=2)
               for i in range(2)]
    batches = []
    for step in range(2):
        shards = [st.batch_at(step) for st in streams]
        batches.append({k: np.stack([sh[k] for sh in shards])
                        for k in shards[0]})
    kw = dict(n_pods=2, per_pod_batch=1, seq=S, device="cpu")
    plain = train.build_train_step(cfg, ecfg, **kw)
    ref = plain.init_state()
    c0 = ref.center.clone()
    for batch in batches:
        ref, _ = plain.step(ref, batch)
    refs = (ref.params, ref.momentum, ref.center, c0)
    out = {}
    for name, (pods, data, model) in cs.MESH_WORLDS:
        mesh = mesh_lib.make_host_mesh(data, model, n_pods=pods,
                                       device="cpu")
        build = train.build_train_step(cfg, ecfg, mesh=mesh, **kw)
        state = build.init_state()
        for batch in batches:
            state, _ = build.step(state, batch)
        out[name] = cs.held_sums(torch, state, refs, cfg, mesh,
                                 build.param_specs)
    return out

"""The port's placement (``launch.mesh``, ``runtime.sharding``,
``models.tp``) on worlds of gloo processes on the CPU, against the
reference.

* A world of 1 (in this process): the meshed step of reduced gemma3-4b
  (``n_pods`` 2, a ``(pod 1, data 1, model 1)`` mesh) equals the
  un-meshed ``build_train_step`` bit for bit over two steps: a world of
  one has nothing to reduce, so any difference would be an op the mesh
  path reorders.
* A ``(pod 2, data 2, model 2)`` world of 8 ranks, the reference's
  ``test_multipod_train_step_matches_reference`` setup: reduced gemma3-4b,
  per-pod batch 4, seq 16, 2 microbatches, packed, η 0.05, ρ 0.02, μ 0.9,
  the state carried across from the reference's ``init_params``
  (``PRNGKey(0)``) by ``state_from_jax(..., mesh=)``, the batch the
  reference's own tokens. After two steps on that batch the gathered state
  is held against the reference's unsharded, unpacked, un-microbatched
  steps: the params to the reference's own 5e-3 in bf16, 1e-4 at f32
  compute (max abs); the momentum (``-eta`` times the gradients) and the
  center's move (the second step's pod mean: the first exchange carries
  zero deltas, since every pod starts at the center) by relative norm, at
  limits that a skipped, doubled or halved pod sum, or a gradient that
  misses a rank's part, exceeds many times over. A third case at f32 runs
  ring over the pod group with bf16 compression (the center's move then
  carries the bf16 rounding of the deltas), FSDP on and overlap off. The
  loss of the second step is held to 1e-3 / 1e-5 relative.
* A ``(data 2, model 2)`` world of 4 ranks serving reduced gemma3-4b at
  f32, B 8, L 32: the prefill's and one decode step's logits against the
  reference's ``prefill`` / ``decode_step`` at its own 1e-4; in the same
  world the ssm, mla, rglru and moe configs' train and serve builds
  succeed (tests/test_torch_mesh_serve.py serves them).

Each rank runs one thread (``torch.set_num_threads(1)``) and joins over a
``FileStore`` under the test's tmp dir. The worlds start first and run
while this process computes the reference's numbers.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import configs as ref_configs
from repro.core import elastic as ref_elastic
from repro.core.easgd import EASGDConfig as RefEASGD
from repro.models import transformer as ref_tfm
from repro.models.common import init_params as ref_init
from repro_torch import configs
from repro_torch.core import elastic
from repro_torch.core.easgd import EASGDConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.runtime import train
from test_torch_mesh_worlds import World, np_tree

EASGD = dict(eta=0.05, rho=0.02, mu=0.9)
N_PODS, BATCH, SEQ, MICRO = 2, 4, 16, 2
TRAIN_CASES = (
    {"name": "bf16", "compute": "bfloat16"},
    {"name": "f32", "compute": "float32"},
    {"name": "f32_ring_fsdp", "compute": "float32", "schedule": "ring",
     "compression": "bf16", "fsdp": True, "overlap": False},
)
PARAM_TOL = {"bf16": 5e-3, "f32": 1e-4, "f32_ring_fsdp": 1e-4}
LOSS_TOL = {"bf16": 1e-3, "f32": 1e-5, "f32_ring_fsdp": 1e-5}
# relative norms of the error in the momentum and in the center's move,
# a few times what this setup reads (bf16 8.7e-3 / 1.4e-2; f32 4.8e-7 /
# 4.5e-5, the center's f32 rounding beside its small move; bf16
# compression 3.8e-3 in the move); a pod sum skipped on every rank reads
# 0.66 in the move, and a model-parallel gradient that misses the other
# rank's part puts the params 2.8e-2 (max abs) off in bf16
MOMENTUM_TOL = {"bf16": 3e-2, "f32": 1e-5, "f32_ring_fsdp": 1e-5}
CENTER_TOL = {"bf16": 5e-2, "f32": 5e-4, "f32_ring_fsdp": 2e-2}
STEPS = 2
SERVE_B, SERVE_L = 8, 32
OTHER = ("mamba2-780m", "deepseek-v2-236b", "recurrentgemma-2b",
         "grok-1-314b")


def _ref_cfg(compute):
    return dataclasses.replace(ref_configs.get("gemma3-4b").reduced,
                               compute_dtype=getattr(jnp, compute))


def _batch():
    cfg = ref_configs.get("gemma3-4b").reduced
    tokens = jax.random.randint(jax.random.PRNGKey(7), (N_PODS, BATCH, SEQ),
                                0, cfg.vocab_size)
    return {"tokens": tokens, "targets": jnp.roll(tokens, -1, -1),
            "mask": jnp.ones((N_PODS, BATCH, SEQ), jnp.float32)}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    cfg = ref_configs.get("gemma3-4b").reduced
    params = ref_init(ref_tfm.model_defs(cfg), jax.random.PRNGKey(0),
                      cfg.param_dtype)
    ecfg = ref_elastic.ElasticConfig(easgd=RefEASGD(**EASGD), packed=True)
    state = ref_elastic.init(params, ecfg, N_PODS)
    batch = _batch()
    toks = jax.random.randint(jax.random.PRNGKey(1),
                              (SERVE_B, SERVE_L - 4), 0, cfg.vocab_size)
    out = tmp_path_factory.mktemp("worlds")
    started = {
        "train": World(8, "train_world", {
            "shape": (2, 2, 2), "cases": TRAIN_CASES, "easgd": EASGD,
            "steps": STEPS,
            "n_pods": N_PODS, "batch": BATCH, "seq": SEQ,
            "microbatches": MICRO, "state": np_tree(state),
            "batch_arrays": {k: np.asarray(v) for k, v in batch.items()}},
            out),
        "serve": World(4, "serve_world", {
            "shape": (2, 2), "B": SERVE_B, "L": SERVE_L,
            "params": np_tree(params), "tokens": np.asarray(toks),
            "easgd": EASGD, "other_archs": OTHER}, out),
    }
    yield {"params": params, "state": state, "batch": batch, "toks": toks,
           **started}
    for w in started.values():
        w.close()


def _leaves(tree):
    return [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(tree)]


def _ref_steps(ref, compute):
    """The reference's unpacked steps on the batch: the last step's loss
    and the state's params, momentum and center leaves."""
    cfg = _ref_cfg(compute)
    gfn = jax.jit(jax.vmap(jax.value_and_grad(
        lambda p, b: ref_tfm.lm_loss(cfg, p, b), has_aux=True)))
    ecfg = ref_elastic.ElasticConfig(easgd=RefEASGD(**EASGD), packed=False)
    st = ref["state"]
    for _ in range(STEPS):
        (loss, _), grads = gfn(st.params, ref["batch"])
        st = ref_elastic.apply_gradients(st, grads, ecfg)
    return float(jnp.mean(loss)), [_leaves(t) for t in (
        st.params, st.momentum, st.center)]


def _rel(got, want, start=None) -> float:
    """``||got - want|| / ||want - start||`` over a list of leaves."""
    num = sum(float(np.sum((a - b) ** 2)) for a, b in zip(got, want))
    base = start or [0.0] * len(want)
    den = sum(float(np.sum((b - c) ** 2)) for b, c in zip(want, base))
    return (num / den) ** 0.5


@pytest.mark.parametrize("case", [c["name"] for c in TRAIN_CASES])
def test_multipod_mesh_step_matches_reference(worlds, case):
    compute = "bfloat16" if case == "bf16" else "float32"
    want_loss, (want, want_v, want_c) = _ref_steps(worlds, compute)
    outs = worlds["train"].results()
    got = outs[0][case]
    n = len(want)
    leaves = got["leaves"][1:1 + n]
    assert [x.shape for x in leaves] == [x.shape for x in want]
    err = max(float(np.max(np.abs(a - b))) for a, b in zip(leaves, want))
    assert err < PARAM_TOL[case], err
    c0 = _leaves(worlds["state"].center)
    rel_v = _rel(got["leaves"][1 + n:1 + 2 * n], want_v)
    rel_c = _rel(got["leaves"][1 + 2 * n:1 + 3 * n], want_c, c0)
    assert rel_v < MOMENTUM_TOL[case], rel_v
    assert rel_c < CENTER_TOL[case], rel_c
    assert abs(got["metrics"]["loss"] - want_loss) \
        <= LOSS_TOL[case] * abs(want_loss)
    # every rank holds one pod's row of a quarter-ish shard: (1, n_local)
    total = sum(x[0].size for x in want)
    shapes = {o[case]["local_shape"] for o in outs}
    assert all(s[0] == 1 and s[1] < total for s in shapes), shapes
    # the gathered states agree on every rank
    for o in outs[1:]:
        for a, b in zip(o[case]["leaves"], got["leaves"]):
            np.testing.assert_array_equal(a, b)


def test_mesh_serving_matches_reference(worlds):
    outs = worlds["serve"].results()
    got = outs[0]
    cfg = _ref_cfg("float32")
    caches = ref_tfm.init_caches(cfg, SERVE_B, SERVE_L)
    lg, caches = jax.jit(lambda p, t, c: ref_tfm.prefill(cfg, p, t, c))(
        worlds["params"], worlds["toks"], caches)
    np.testing.assert_allclose(got["logits"], np.asarray(lg), rtol=1e-4,
                               atol=1e-4)
    pos = jnp.full((SERVE_B,), SERVE_L - 4, jnp.int32)
    tok = jnp.asarray(got["tok"], jnp.int32)
    lg2, _ = jax.jit(lambda p, t, c, q: ref_tfm.decode_step(cfg, p, t, c,
                                                           q))(
        worlds["params"], tok, caches, pos)
    np.testing.assert_allclose(got["logits2"], np.asarray(lg2), rtol=1e-4,
                               atol=1e-4)
    # every rank returns the whole logits; its caches are its block
    for o in outs[1:]:
        np.testing.assert_array_equal(o["logits2"], got["logits2"])
    cfg_p = configs.get("gemma3-4b").reduced
    assert got["cache_shape"] == (cfg_p.n_periods, SERVE_B // 2,
                                  cfg_p.window, cfg_p.n_kv_heads // 2,
                                  cfg_p.resolved_head_dim)
    assert tuple(got["specs"][0]) == ("data", None) and got["specs"][1]


@pytest.mark.parametrize("arch", OTHER)
def test_mesh_builds_every_kind(worlds, arch):
    """Training and serving place every kind on the mesh: the ssm, mla,
    rglru and moe configs' builds succeed on every rank
    (tests/test_torch_mesh_kinds*.py hold the steps,
    tests/test_torch_mesh_serve.py the serving)."""
    for o in worlds["serve"].results():
        built = o["built"]
        assert built[(arch, "train")] is None, built[(arch, "train")]
        assert built[(arch, "serve")] is None, built[(arch, "serve")]


WORLD1_CASES = {
    "m1_psum": dict(microbatches=1, schedule="psum", compression="none",
                    overlap=True, fsdp=False),
    "m2_ring_bf16_fsdp": dict(microbatches=2, schedule="ring",
                              compression="bf16", overlap=True, fsdp=True),
    "m2_psum_no_overlap_tau2": dict(microbatches=2, schedule="psum",
                                    compression="none", overlap=False,
                                    fsdp=False, tau=2),
}


@pytest.mark.parametrize("case", sorted(WORLD1_CASES))
def test_world_of_one_equals_unmeshed_bitwise(case):
    c = WORLD1_CASES[case]
    cfg = dataclasses.replace(configs.get("gemma3-4b").reduced,
                              fsdp=c["fsdp"])
    ecfg = elastic.ElasticConfig(
        easgd=EASGDConfig(**EASGD, tau=c.get("tau", 1)),
        schedule=c["schedule"], compression=c["compression"],
        overlap=c["overlap"])
    kw = dict(n_pods=N_PODS, per_pod_batch=BATCH, seq=SEQ,
              microbatches=c["microbatches"], device="cpu")
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, (N_PODS, BATCH, SEQ))
    batch = {"tokens": tokens.astype(np.int32),
             "targets": np.roll(tokens, -1, -1).astype(np.int32),
             "mask": np.ones((N_PODS, BATCH, SEQ), np.float32)}
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = mesh_lib.make_host_mesh(1, 1, n_pods=1, device="cpu")
        plain = train.build_train_step(cfg, ecfg, **kw)
        meshed = train.build_train_step(cfg, ecfg, mesh=mesh, **kw)
        assert meshed.param_specs is not None and plain.param_specs is None
        s0, s1 = plain.init_state(), meshed.init_state()
        for step in range(3):
            for a, b in ((s0.params, s1.params), (s0.momentum, s1.momentum),
                         (s0.center, s1.center), (s0.ef_error, s1.ef_error)):
                assert (a is None and b is None) or torch.equal(a, b), step
            if step == 2:
                break
            s0, m0 = plain.step(s0, batch)
            s1, m1 = meshed.step(s1, batch)
            for k in m0:
                assert torch.equal(m0[k], m1[k]), (k, step)
    finally:
        dist.destroy_process_group()

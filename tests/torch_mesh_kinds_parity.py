"""What tests/test_torch_mesh_kinds*.py share: the reference's unsharded
steps of a mesh-kinds case and the holds of a world's gathered state
against them (the worlds are in tests/test_torch_mesh_worlds.py).

Every case starts from the reference's ``init_params`` (``PRNGKey(0)``)
carried across by ``state_from_jax(..., mesh=)`` and takes two packed
steps of one pod (η 0.05, ρ 0.02, μ 0.9) on one batch of the reference's
own tokens (B 4, S 16; no microbatches, so a MoE layer routes the same
64 tokens on both sides); the reference runs them unsharded and
unpacked.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from repro import configs as ref_configs
from repro.core import elastic as ref_elastic
from repro.core.easgd import EASGDConfig as RefEASGD
from repro.models import transformer as ref_tfm
from repro.models.common import init_params as ref_init
from test_torch_mesh_worlds import np_tree

EASGD = dict(eta=0.05, rho=0.02, mu=0.9)
BATCH, SEQ, STEPS = 4, 16, 2
QUANTITIES = ("params", "momentum", "center", "loss", "aux")


def ref_cfg(case: dict):
    base = ref_configs.get(case["arch"]).reduced
    kw = {k: dataclasses.replace(getattr(base, k), **v)
          if isinstance(v, dict) else v
          for k, v in case.get("cfg", {}).items()
          if k not in ("fsdp", "moe_ep")}   # placement only
    return dataclasses.replace(base, compute_dtype=getattr(
        jnp, case["compute"]), **kw)


def ref_start(case: dict):
    """The reference's initial state and batch for a case: numpy trees
    for the world's payload and the JAX originals."""
    cfg = ref_cfg(case)
    params = ref_init(ref_tfm.model_defs(cfg), jax.random.PRNGKey(0),
                      cfg.param_dtype)
    ecfg = ref_elastic.ElasticConfig(easgd=RefEASGD(**EASGD), packed=True)
    state = ref_elastic.init(params, ecfg, 1)
    tokens = jax.random.randint(jax.random.PRNGKey(7), (1, BATCH, SEQ), 0,
                                cfg.vocab_size)
    batch = {"tokens": tokens, "targets": jnp.roll(tokens, -1, -1),
             "mask": jnp.ones((1, BATCH, SEQ), jnp.float32)}
    return state, batch


def payload_of(starts: dict) -> dict:
    return {"states": {k: np_tree(s) for k, (s, _) in starts.items()},
            "batches": {k: {n: np.asarray(v) for n, v in b.items()}
                        for k, (_, b) in starts.items()}}


def leaves(tree):
    return [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(tree)]


def ref_steps(case: dict, start) -> dict:
    """The reference's unsharded steps: the leaves of the params,
    momentum and center after them, the center before, and the last
    step's loss and aux."""
    cfg = ref_cfg(case)
    state, batch = start
    gfn = jax.jit(jax.vmap(jax.value_and_grad(
        lambda p, b: ref_tfm.lm_loss(cfg, p, b), has_aux=True)))
    ecfg = ref_elastic.ElasticConfig(easgd=RefEASGD(**EASGD), packed=False)
    upd = jax.jit(lambda s, g: ref_elastic.apply_gradients(s, g, ecfg))
    c0 = leaves(state.center)
    for _ in range(STEPS):
        (loss, mets), grads = gfn(state.params, batch)
        state = upd(state, grads)
    return {"params": leaves(state.params), "momentum": leaves(
        state.momentum), "center": leaves(state.center), "c0": c0,
        "loss": float(loss[0]), "aux": float(mets["aux"][0])}


def rel(got, want, start=None) -> float:
    """``||got - want|| / ||want - start||`` over a list of leaves."""
    num = sum(float(np.sum((a - b) ** 2)) for a, b in zip(got, want))
    base = start or [0.0] * len(want)
    den = sum(float(np.sum((b - c) ** 2)) for b, c in zip(want, base))
    return (num / den) ** 0.5


def readings(got: dict, want: dict) -> dict:
    """A world's case against the reference: the params' largest error
    (max abs), the momentum's and the center's move's relative norms,
    the last loss's and aux's relative errors."""
    n = len(want["params"])
    lv = got["leaves"]
    params, mom, cen = lv[1:1 + n], lv[1 + n:1 + 2 * n], lv[1 + 2 * n:]
    assert [x.shape for x in params] == [x.shape for x in want["params"]]
    m = got["metrics"][-1]
    return {
        "params": max(float(np.max(np.abs(a - b)))
                      for a, b in zip(params, want["params"])),
        "momentum": rel(mom, want["momentum"]),
        "center": rel(cen, want["center"], want["c0"]),
        "loss": abs(m["loss"] - want["loss"]) / abs(want["loss"]),
        "aux": abs(m["aux"] - want["aux"]) / max(abs(want["aux"]), 1e-30)}


def hold(got: dict, want: dict, limits: dict, fault=None):
    """Hold a case's readings to its limits; a case with a planted fault
    must read at least ten times its limit in the quantity ``fault``
    names."""
    r = readings(got, want)
    if fault is None:
        for q in QUANTITIES:
            assert r[q] <= limits[q], (q, r[q], limits[q], r)
    else:
        assert r[fault] >= 10 * limits[fault], (fault, r[fault], r)
    return r

"""Shared by the port's family tests (tests/test_torch_families*.py,
tests/test_torch_rglru.py): one reduced config's ``lm_loss`` and flat
gradient in the reference, on its own ``init_params``, and the same batch
through the port with those params carried across by ``params_from_jax``.

The tolerances are those of tests/test_torch_lm.py: f32 compute on both
sides, loss 1e-5 relative and gradient 1e-4 relative norm (only the order
of f32 sums differs); the config's bf16 compute, 1e-3 and 5e-2 (bf16
rounds at other places in the two frameworks). A MoE config's aux loss is
held to the loss's tolerance; without MoE it is 0 on both sides.

Where a reduced config has no qk-norm, the reference's init (``wq`` and
``wk`` drawn with fan-in H, the stacked shape's second-to-last dim) gives
attention scores of standard deviation ~16, an almost one-hot softmax,
and a gradient so ill-conditioned that the reference's own bf16 gradient
lies farther from its f64-compute one than the bf16 limit: no two bf16
evaluations meet a limit there. ``conditioned=True`` feeds both sides
the reference's params with ``wq`` / ``wk`` rescaled to fan-in d_model
(as chip_smoke.py's ``lm_params`` draws them at full width) and holds
them at the same limits. MLA's ``w_uq`` / ``w_uk`` are drawn the same way
(fan-in H where they contract over q_lora_rank / kv_lora_rank) and are
rescaled to their contraction dim alike.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax import flatten_util

from repro import configs as ref_configs
from repro.models import transformer as ref_tfm
from repro.models.common import init_params as ref_init
from repro_torch import configs
from repro_torch.models import transformer as tfm

TOLS = {"f32": (1e-5, 1e-4), "bf16": (1e-3, 5e-2)}
# the query and key projections whose init the conditioned draw rescales
QK_LEAVES = (("attn", "wq"), ("attn", "wk"), ("attn", "w_uq"),
             ("attn", "w_uk"))
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def key(k):
    return k.key if hasattr(k, "key") else k.idx


def ref_params(arch: str, conditioned=False):
    """The reference's reduced ``init_params``; with ``conditioned``,
    ``wq`` and ``wk`` rescaled from fan-in H to fan-in d_model."""
    cfg = ref_configs.get(arch).reduced
    params = ref_init(ref_tfm.model_defs(cfg), jax.random.PRNGKey(0),
                      jnp.float32)
    if not conditioned:
        return params

    def scale(path, a):
        # the contraction dim: d_model for wq / wk, MLA's q_lora_rank for
        # w_uq and kv_lora_rank for w_uk
        if tuple(key(k) for k in path)[-2:] in QK_LEAVES:
            return a * math.sqrt(a.shape[-2] / a.shape[-3])
        return a
    return jax.tree_util.tree_map_with_path(scale, params)


def ref_layout(arch: str) -> list:
    """``[(path, shape)]`` of the reference's reduced params, in
    ``ravel_pytree`` order."""
    return [(tuple(key(k) for k in path), tuple(leaf.shape))
            for path, leaf in
            jax.tree_util.tree_leaves_with_path(ref_params(arch))]


def batch(cfg, seed=3, B=2, S=24, extras=False) -> dict:
    """A masked numpy batch; with ``extras``, distinct t / h / w M-RoPE
    positions (the t stream the sequence, h and w a 4 x 6 patch grid) and
    ``cfg.patch_embed_tokens`` patch embeddings drawn from the seed."""
    rng = np.random.RandomState(seed)
    t = rng.randint(0, cfg.vocab_size, size=(B, S + 1))
    out = {"tokens": t[:, :-1], "targets": t[:, 1:],
           "mask": (rng.rand(B, S) > 0.2).astype(np.float32)}
    if extras:
        s = np.arange(S)
        out["mrope_positions"] = np.broadcast_to(
            np.stack([s, s // 6, s % 6])[:, None], (3, B, S)).astype(
            np.int32).copy()
        out["patch_embeds"] = rng.randn(
            B, cfg.patch_embed_tokens, cfg.d_model).astype(np.float32)
    return out


def reference(arch: str, dt: str, np_batch: dict, conditioned=False):
    """The reference's (flat params, loss, metrics, flat gradient) at the
    reduced config with ``dt`` compute."""
    rcfg = dataclasses.replace(ref_configs.get(arch).reduced,
                               compute_dtype=DTYPES[dt][0])
    flat, unravel = flatten_util.ravel_pytree(ref_params(arch, conditioned))
    jb = {k: jnp.asarray(v) for k, v in np_batch.items()}
    (loss, metrics), grad = jax.value_and_grad(
        lambda w: ref_tfm.lm_loss(rcfg, unravel(w), jb), has_aux=True)(flat)
    return (np.asarray(flat), float(loss),
            {k: float(v) for k, v in metrics.items()}, np.asarray(grad))


def port(arch: str, dt: str, flat, np_batch: dict):
    """The port's (loss, metrics, flat gradient) on the reference's
    params."""
    pcfg = dataclasses.replace(configs.get(arch).reduced,
                               compute_dtype=DTYPES[dt][1])
    _, row = tfm.params_from_jax(flat, pcfg, device="cpu")
    leaf = row.to(torch.float32).requires_grad_(True)
    loss, metrics = tfm.lm_loss(pcfg, tfm.unflatten(leaf, pcfg), {
        k: torch.from_numpy(np.asarray(v)) for k, v in np_batch.items()})
    loss.backward()
    return loss.item(), {k: v.item() for k, v in metrics.items()}, \
        leaf.grad.numpy()


def assert_parity(arch: str, dt: str, extras=False,
                  conditioned=False) -> tuple:
    """Hold the port's loss, metrics and gradient against the reference's
    at ``dt``'s tolerances, on the reference's init or, with
    ``conditioned``, on it with q / k at fan-in d_model; returns the
    (loss, gradient) readings."""
    cfg = configs.get(arch).reduced
    b = batch(cfg, extras=extras)
    flat, want_loss, want_m, want_grad = reference(arch, dt, b, conditioned)
    loss, m, grad = port(arch, dt, flat, b)
    tol_loss, tol_grad = TOLS[dt]
    r_loss = abs(loss - want_loss) / abs(want_loss)
    r_grad = rel(grad, want_grad)
    assert np.isfinite(loss) and np.isfinite(grad).all()
    assert r_loss <= tol_loss, (arch, dt, r_loss)
    assert m["tokens"] == want_m["tokens"]
    if want_m["aux"] == 0.0:                 # no MoE layer
        assert m["aux"] == 0.0
    else:                                    # the MoE load-balance loss
        assert abs(m["aux"] - want_m["aux"]) <= tol_loss * want_m["aux"]
    assert abs(m["accuracy"] - want_m["accuracy"]) <= 1.0 / want_m["tokens"]
    assert r_grad <= tol_grad, (arch, dt, r_grad)
    return r_loss, r_grad

"""Multi-head Latent Attention in the port (``repro_torch.models.mla``)
against the reference's ``repro.models.mla``, the attention plain versions
at a V head dim apart from Q/K's against the reference's training path,
and deepseek-v2-236b's reduced LM against the reference's.

Inputs and parameters come from numpy seeds and go to both sides. Held:

* ``mla_block`` at the reduced deepseek-v2 (Dqk 24 = 16 nope + 8 rope, Dv
  16), f32 compute: y within 1e-5 (relative norm), the gradients of
  ``Σ y·g`` with respect to x and every parameter against ``jax.grad``
  within 1e-4;
* ``flash_attention_fwd_ref`` / ``flash_attention_bwd_ref`` at Dqk 24 / Dv
  16, causal and not, against ``_flash_fwd_impl`` / ``_flash_bwd_impl``:
  out and lse within 1e-5, dq, dk, dv within 1e-4;
* deepseek-v2-236b's reduced ``lm_loss`` and gradient (tests/
  torch_lm_parity.py: f32 1e-5 / 1e-4 on the reference's init; bf16 1e-3
  / 5e-2 with w_uq / w_uk at fan-in of their contraction dim, the
  reference's fan-in H making the bf16 gradient ill-conditioned).

Readings on this CPU: mla_block y ≤ 2.3e-7, gradients ≤ 4.3e-7; attention
out and lse ≤ 2.1e-7, gradients ≤ 2.9e-7; deepseek's LM f32 loss 7.3e-8,
gradient 3.1e-6, bf16 (conditioned) loss 4.8e-5, gradient 1.1e-2.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import attention as ref_attn
from repro.models import mla as ref_mla
from repro_torch import configs
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import mla
from torch_lm_parity import assert_parity
from torch_serve_parity import decode_rows, walk_block

ARCH = "deepseek-v2-236b"


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _inputs(cfg, B, S, seed):
    rng = np.random.RandomState(seed)
    p = {}
    for name, d in sorted(mla.mla_defs(cfg).items()):
        if d.init == "zeros":
            p[name] = (0.1 * rng.randn(*d.shape)).astype(np.float32)
        else:
            fan_in = d.shape[0]              # the contraction dim
            p[name] = (rng.randn(*d.shape) / np.sqrt(fan_in)).astype(
                np.float32)
    x = rng.randn(B, S, cfg.d_model).astype(np.float32)
    g = rng.randn(B, S, cfg.d_model).astype(np.float32)
    return x, p, g


@pytest.mark.parametrize("B,S", [(2, 24), (1, 40)])
def test_mla_block_and_gradients_match_reference(B, S):
    rcfg = dataclasses.replace(ref_configs.get(ARCH).reduced,
                               compute_dtype=jnp.float32)
    pcfg = dataclasses.replace(configs.get(ARCH).reduced,
                               compute_dtype=torch.float32)
    x, p, g = _inputs(pcfg, B, S, seed=S)
    pos = np.broadcast_to(np.arange(S)[None], (B, S))

    def ref_obj(params, xx):
        y, _ = ref_mla.mla_block(rcfg, params, xx, jnp.asarray(pos))
        return jnp.sum(y * g), y
    (_, y_ref), (want_p, want_x) = jax.value_and_grad(
        ref_obj, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))

    pt = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y, cache = mla.mla_block(pcfg, pt, xt, torch.from_numpy(pos.copy()))
    assert cache is None and y.shape == (B, S, pcfg.d_model)
    assert _rel(y.detach().numpy(), y_ref) <= 1e-5
    (y * torch.from_numpy(g)).sum().backward()
    assert _rel(xt.grad.numpy(), want_x) <= 1e-4
    for name in sorted(p):
        assert _rel(pt[name].grad.numpy(), want_p[name]) <= 1e-4, name


@pytest.mark.parametrize("n_prefill,S,Sc,rows", [
    (6, 11, 11, None), (3, 9, 12, None), (12, 12, 10, None),
    (None, 1, 10, [0, 9, 4])])
def test_mla_block_serving_matches_reference(n_prefill, S, Sc, rows):
    """The prefill's compressed (ckv, kpe) fill, the reach past the cache
    (S 12 into Sc 10 writes the first Sc tokens, as the reference does),
    and the absorbed decode: each call's output and cache leaves, f32
    1e-5; one decode step from a random cache at per-row positions."""
    rcfg = dataclasses.replace(ref_configs.get(ARCH).reduced,
                               compute_dtype=jnp.float32)
    pcfg = dataclasses.replace(configs.get(ARCH).reduced,
                               compute_dtype=torch.float32)
    a = pcfg.mla
    B = len(rows) if rows else 2
    x, p, _ = _inputs(pcfg, B, S, seed=S + Sc)
    fns = (partial(ref_mla.mla_block, rcfg), partial(mla.mla_block, pcfg))
    shapes = {"ckv": (B, Sc, a.kv_lora_rank),
              "kpe": (B, Sc, a.qk_rope_head_dim)}
    if rows is None:
        walk_block(*fns, p, x, {k: np.zeros(sh, np.float32)
                                for k, sh in shapes.items()}, n_prefill)
    else:
        rng = np.random.RandomState(2)
        decode_rows(*fns, p, x, {k: rng.randn(*sh).astype(np.float32)
                                 for k, sh in shapes.items()}, rows)


@pytest.mark.parametrize("causal,S,qb,kb", [(True, 24, 8, 8),
                                            (True, 48, 16, 8),
                                            (False, 32, 8, 16)])
def test_attention_plain_versions_at_dv_apart(causal, S, qb, kb):
    """Dqk 24, Dv 16 (the reduced deepseek-v2's pair), GQA 4 / 2."""
    rng = np.random.RandomState(S)
    B, H, KVH, D, Dv = 2, 4, 2, 24, 16
    q, k, v, do = (rng.randn(B, S, h, w).astype(np.float32)
                   for h, w in ((H, D), (KVH, D), (KVH, Dv), (H, Dv)))
    out_r, lse_r = ref_attn._flash_fwd_impl(
        *(jnp.asarray(a) for a in (q, k, v)), causal, 0, qb, kb)
    dq_r, dk_r, dv_r = ref_attn._flash_bwd_impl(
        *(jnp.asarray(a) for a in (q, k, v)), out_r, lse_r,
        jnp.asarray(do), causal, 0, qb, kb)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = fa.flash_attention_fwd(tq, tk, tv, causal, 0, qb, kb)
    assert out.shape == (B, S, H, Dv)
    assert _rel(out.numpy(), out_r) <= 1e-5
    assert _rel(lse.numpy(), lse_r) <= 1e-5
    grads = fa.flash_attention_bwd(tq, tk, tv, out, lse, tdo, causal, 0,
                                   qb, kb)
    for got, want, x in zip(grads, (dq_r, dk_r, dv_r), (q, k, v)):
        assert got.shape == x.shape
        assert _rel(got.numpy(), want) <= 1e-4


def test_attention_wrapper_takes_v_at_its_own_width_only():
    q = torch.zeros(1, 8, 2, 24)
    with pytest.raises(ValueError, match="Dv"):
        fa.flash_attention_fwd(q, q, torch.zeros(1, 8, 1, 16))


@pytest.mark.parametrize("dt,conditioned", [("f32", False), ("bf16", True)])
def test_deepseek_lm_loss_and_gradient_match_reference(dt, conditioned):
    assert_parity(ARCH, dt, conditioned=conditioned)

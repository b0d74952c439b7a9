"""The RG-LRU block (``repro_torch.models.rglru``) against the reference's
``repro.models.rglru``, recurrentgemma-2b's ``lm_loss`` against the
reference's, and a short ``run_ps`` on it.

The gates run in f32 on both sides; the port's scan doubles (Hillis-
Steele) where ``lax.associative_scan`` builds a tree, so the two sum in
other orders: held at the f32 limits, 1e-5 forward and 1e-4 gradients.
Readings on this CPU: scan 1.5e-7 (max |err|), conv 0 (the same products
and sums), block 4.2e-7 (max |err|), block gradients 4.9e-7 (relative
norm). recurrentgemma-2b reduced (one
period of two RG-LRU layers and a local-attention layer, then two
remainder RG-LRU layers): f32 loss 1e-5 (7.6e-8), gradient 1e-4 (8.9e-6);
bf16, on the reference's init with the local layer's ``wq`` / ``wk`` at
fan-in d_model (no qk-norm, tests/torch_lm_parity.py), loss 1e-3 (2.0e-4),
gradient 5e-2 (2.7e-2).
"""
import dataclasses
import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import rglru as ref_rglru
from repro_torch import configs, kernels
from repro_torch.core.easgd import EASGDConfig
from repro_torch.models import rglru
from repro_torch.models import transformer as tfm
from repro_torch.ps import runtime, zoo
from torch_lm_parity import assert_parity, rel
from torch_serve_parity import decode_rows, walk_block

ARCH = "recurrentgemma-2b"


def _cfgs(width=32):
    ref = dataclasses.replace(
        ref_configs.get(ARCH).reduced, d_model=width,
        compute_dtype=jnp.float32,
        rglru=dataclasses.replace(ref_configs.get(ARCH).reduced.rglru,
                                  width=width))
    port = dataclasses.replace(
        configs.get(ARCH).reduced, d_model=width,
        compute_dtype=torch.float32,
        rglru=dataclasses.replace(configs.get(ARCH).reduced.rglru,
                                  width=width))
    return ref, port


def _params(width, seed=0):
    rng = np.random.RandomState(seed)
    p = {"w_y": rng.randn(width, width) / math.sqrt(width),
         "w_x": rng.randn(width, width) / math.sqrt(width),
         "conv_w": rng.randn(4, width) * 0.5, "conv_b": rng.randn(width) * 0.1,
         "wa": rng.randn(width, width) / math.sqrt(width),
         "ba": rng.randn(width) * 0.1,
         "wi": rng.randn(width, width) / math.sqrt(width),
         "bi": rng.randn(width) * 0.1, "lam": rng.randn(width) + 1.0,
         "w_out": rng.randn(width, width) / math.sqrt(width)}
    return {k: v.astype(np.float32) for k, v in p.items()}


def test_defs_are_the_reference_defs():
    ref, port = _cfgs(48)
    mine, theirs = rglru.rglru_defs(port), ref_rglru.rglru_defs(ref)
    assert sorted(mine) == sorted(theirs)
    for k in mine:
        assert (mine[k].shape, mine[k].logical, mine[k].init) == \
            (theirs[k].shape, theirs[k].logical, theirs[k].init), k


@pytest.mark.parametrize("S", [1, 7, 64, 300])
def test_scan_matches_reference(S):
    ref, port = _cfgs()
    p = _params(32, seed=S)
    x = np.random.RandomState(S).randn(2, S, 32).astype(np.float32)
    want = ref_rglru.rglru_scan(ref, {k: jnp.asarray(v) for k, v in
                                      p.items()}, jnp.asarray(x))
    got = rglru.rglru_scan(port, {k: torch.from_numpy(v) for k, v in
                                  p.items()}, torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_linear_scan_is_the_recurrence():
    rng = np.random.RandomState(1)
    a = torch.from_numpy(rng.rand(3, 37, 5))
    b = torch.from_numpy(rng.randn(3, 37, 5))
    h, want = torch.zeros(3, 5, dtype=torch.float64), []
    for t in range(37):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    got = rglru.linear_scan(a, b)
    assert torch.allclose(got, torch.stack(want, 1), rtol=1e-12, atol=1e-12)


def test_causal_conv_matches_reference():
    rng = np.random.RandomState(2)
    x, w, b = (rng.randn(2, 20, 8).astype(np.float32),
               rng.randn(4, 8).astype(np.float32),
               rng.randn(8).astype(np.float32))
    want = ref_rglru._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(b))
    got = rglru._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_block_and_its_gradients_match_reference():
    ref, port = _cfgs()
    p = _params(32, seed=5)
    x = np.random.RandomState(5).randn(2, 40, 32).astype(np.float32)
    dy = np.random.RandomState(6).randn(2, 40, 32).astype(np.float32)

    def f(p, x):
        y, _ = ref_rglru.rglru_block(ref, p, x)
        return jnp.sum(y * dy), y

    (_, want_y), want_g = jax.value_and_grad(f, argnums=(0, 1),
                                             has_aux=True)(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, cache = rglru.rglru_block(port, tp, tx)
    assert cache is None
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               rtol=1e-5, atol=1e-5)
    (y * torch.from_numpy(dy)).sum().backward()
    assert rel(tx.grad.numpy(), want_g[1]) <= 1e-4
    for k in p:
        assert rel(tp[k].grad.numpy(), want_g[0][k]) <= 1e-4, k


def test_rglru_step_matches_reference():
    ref, port = _cfgs()
    p = _params(32, seed=3)
    rng = np.random.RandomState(6)
    x_t = rng.randn(3, 32).astype(np.float32)
    h0 = rng.randn(3, 32).astype(np.float32)
    want_y, want_h = ref_rglru.rglru_step(
        ref, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x_t),
        jnp.asarray(h0))
    got_y, got_h = rglru.rglru_step(
        port, {k: torch.from_numpy(v) for k, v in p.items()},
        torch.from_numpy(x_t), torch.from_numpy(h0))
    assert got_h.dtype == torch.float32
    assert rel(got_y.numpy(), want_y) <= 1e-5
    assert rel(got_h.numpy(), want_h) <= 1e-5


@pytest.mark.parametrize("n_prefill,S,rows", [(9, 13, None), (4, 6, None),
                                              (None, 1, [3, 17])])
def test_rglru_block_prefill_and_decode_match_reference(n_prefill, S, rows):
    """The prefill's conv history and ``h[:, -1]`` in f32, then each decode
    step's output, conv history and state; and one decode step from a
    random cache at per-row positions. f32 1e-5."""
    ref, port = _cfgs()
    p = _params(32, seed=4)
    rng = np.random.RandomState(S)
    B = 2
    x = rng.randn(B, S, 32).astype(np.float32)
    fns = (partial(ref_rglru.rglru_block, ref),
           partial(rglru.rglru_block, port))
    if rows is None:
        cache = {"conv": np.zeros((B, 3, 32), np.float32),
                 "state": np.zeros((B, 32), np.float32)}
        walk_block(*fns, p, x, cache, n_prefill)
    else:
        cache = {"conv": rng.randn(B, 3, 32).astype(np.float32),
                 "state": rng.randn(B, 32).astype(np.float32)}
        decode_rows(*fns, p, x, cache, rows)


@pytest.mark.parametrize("dt,conditioned", [("f32", False),
                                            ("bf16", True)])
def test_recurrentgemma_matches_reference(dt, conditioned):
    assert_parity(ARCH, dt, conditioned=conditioned)


def test_short_ps_run_on_recurrentgemma():
    p, rounds = 2, 3
    cfg = runtime.PSConfig(algorithm="sync_sgd", n_workers=p,
                           total_iters=p * rounds, eval_every_iters=10**9,
                           bucket_bytes=65536)
    kernels.reset_launch_counts()
    res = runtime.run_ps(zoo.resolve(ARCH), EASGDConfig(eta=0.05, rho=0.05),
                         cfg, device="cpu")
    n = tfm.n_params(configs.get(ARCH).reduced)
    assert res.center.shape == (n,) and res.workers.shape == (p, n)
    assert bool(torch.isfinite(res.center).all())
    assert math.isfinite(res.final_metric) and res.final_metric < 7.0
    assert all(v == 0 for v in kernels.launch_counts().values())

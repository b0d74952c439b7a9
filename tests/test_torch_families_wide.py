"""gemma3-27b (reduced: one period of five local and one global layer and
two remainder local layers, head dim 24) and qwen2-vl-72b (M-RoPE, the
vision stub's patch embeddings) against the reference, ``apply_mrope``
against the reference's, the qwen2-vl PS problem against the reference's,
and a short ``run_ps`` on gemma3-27b.

Limits (tests/torch_lm_parity.py) and the readings on this CPU:

* gemma3-27b: f32 loss 1e-5 (read 0), gradient 1e-4 (6.4e-7); bf16 loss
  1e-3 (2.7e-5), gradient 5e-2 (1.1e-2);
* qwen2-vl-72b, distinct t / h / w positions and 8 patch-embedding
  positions: f32 loss (0), gradient (3.9e-5); bf16, on the reference's
  init with ``wq`` / ``wk`` at fan-in d_model (no qk-norm), loss (1.0e-5),
  gradient (7.8e-3).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ref_attn
from repro.ps import zoo as ref_zoo
from repro_torch import configs, kernels
from repro_torch.core.easgd import EASGDConfig
from repro_torch.models import attention
from repro_torch.models import transformer as tfm
from repro_torch.models.common import init_params
from repro_torch.ps import runtime, zoo
from torch_lm_parity import TOLS, assert_parity


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_gemma3_27b_matches_reference(dt):
    assert_parity("gemma3-27b", dt)


@pytest.mark.parametrize("dt,conditioned", [("f32", False),
                                            ("bf16", True)])
def test_qwen2_vl_with_mrope_and_patches_matches_reference(dt, conditioned):
    assert_parity("qwen2-vl-72b", dt, extras=True, conditioned=conditioned)


def _close(got, want, tol=1e-6):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("sections", [(2, 3, 3), (16, 24, 24), (5, 1, 2)])
def test_apply_mrope_matches_reference(sections):
    D = 2 * sum(sections)
    rng = np.random.RandomState(D)
    x = rng.randn(2, 12, 3, D).astype(np.float32)
    pos = rng.randint(0, 50, size=(3, 2, 12)).astype(np.int32)
    for theta in (1e4, 1e6):
        want = ref_attn.apply_mrope(jnp.asarray(x), jnp.asarray(pos), theta,
                                    sections)
        got = attention.apply_mrope(torch.from_numpy(x),
                                    torch.from_numpy(pos), theta, sections)
        _close(got, want, 1e-5)
    bf = attention.apply_mrope(torch.from_numpy(x).bfloat16(),
                               torch.from_numpy(pos), 1e4, sections)
    assert bf.dtype == torch.bfloat16


def test_apply_mrope_with_one_stream_is_rope():
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 9, 4, 16)
                         .astype(np.float32))
    pos = torch.arange(9)[None].expand(2, 9)
    got = attention.apply_mrope(x, pos[None].expand(3, 2, 9), 1e6, (2, 3, 3))
    assert torch.equal(got, attention.apply_rope(x, pos, 1e6))
    with pytest.raises(ValueError, match="sections"):
        attention.apply_mrope(x, pos[None].expand(3, 2, 9), 1e6, (2, 3, 2))


def test_patch_embeds_replace_the_leading_positions():
    cfg = configs.get("qwen2-vl-72b").reduced
    params = init_params(tfm.model_defs(cfg),
                         torch.Generator().manual_seed(0))
    tok = torch.randint(0, cfg.vocab_size, (1, 16),
                        generator=torch.Generator().manual_seed(1))
    patches = torch.randn(1, cfg.patch_embed_tokens, cfg.d_model,
                          generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        h0, _, _ = tfm.forward(cfg, params, tok)
        h1, _, _ = tfm.forward(cfg, params, tok, patch_embeds=patches)
        tok2 = tok.clone()
        tok2[:, :cfg.patch_embed_tokens] = (tok2[:, :cfg.patch_embed_tokens]
                                            + 1) % cfg.vocab_size
        h2, _, _ = tfm.forward(cfg, params, tok2, patch_embeds=patches)
    assert not torch.equal(h0, h1)
    # the patched positions' token ids no longer matter
    assert torch.equal(h1, h2)


def test_qwen2_vl_ps_problem_matches_reference():
    """The PS problem passes the positions broadcast over the three M-RoPE
    streams, as the reference's does: its gradient is ``lm_loss``'s on
    that batch, bit for bit, and its eval loss the reference's within the
    bf16 loss limit (the bf16 gradient of this reduced config is too
    ill-conditioned to compare, tests/torch_lm_parity.py)."""
    arch = "qwen2-vl-72b"
    cfg = configs.get(arch).reduced
    w0, ref_grad, ref_eval = ref_zoo.make_zoo_lm(arch)
    row, grad_fn, eval_fn = zoo.make_zoo_lm(arch, w0=w0, device="cpu")
    assert grad_fn.layer_sizes == ref_grad.layer_sizes
    tok = np.random.RandomState(1000 + 5).randint(0, cfg.vocab_size,
                                                  size=(2, 25))
    leaf = row.to(torch.float32).requires_grad_(True)
    loss, _ = tfm.lm_loss(cfg, tfm.unflatten(leaf, cfg), {
        "tokens": torch.from_numpy(tok[:, :-1]),
        "targets": torch.from_numpy(tok[:, 1:]),
        "mask": torch.ones(2, 24),
        "mrope_positions": torch.arange(24)[None, None].expand(3, 2, 24)})
    loss.backward()
    assert torch.equal(grad_fn(row, 0, 5), leaf.grad.to(torch.float64))
    assert abs(eval_fn(row) - ref_eval(w0)) <= TOLS["bf16"][0] * ref_eval(w0)


def test_short_ps_run_on_gemma3_27b():
    p, rounds = 2, 3
    cfg = runtime.PSConfig(algorithm="sync_easgd", n_workers=p,
                           total_iters=p * rounds, eval_every_iters=10**9,
                           bucket_bytes=65536)
    kernels.reset_launch_counts()
    res = runtime.run_ps(zoo.resolve("gemma3-27b"),
                         EASGDConfig(eta=0.05, rho=0.05), cfg, device="cpu")
    n = tfm.n_params(configs.get("gemma3-27b").reduced)
    assert res.center.shape == (n,) and res.workers.shape == (p, n)
    assert bool(torch.isfinite(res.center).all())
    assert math.isfinite(res.final_metric) and res.final_metric < 7.0
    assert res.total_iters == p * rounds
    assert all(v == 0 for v in kernels.launch_counts().values())

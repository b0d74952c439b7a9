"""The port's Mamba-2 path (``repro_torch.models.ssm`` and the ``ssm``
layer kind of ``repro_torch.models.transformer``) against the reference,
on mamba2-780m's reduced config with the reference's own params carried
across by ``params_from_jax``.

Tolerances (as tests/test_torch_lm.py states them):

* f32 on both sides: ``_ssd_chunked`` and the block 1e-5 by relative norm;
  loss ≤ 1e-5 relative, gradient ≤ 1e-4 relative norm. Only the order of
  f32 sums differs (the intra-chunk term goes through the port's SSD
  plain version, the inter-chunk pass is vectorised over chunks).
* the config's bf16 compute: loss ≤ 1e-3 relative, block output and
  gradient ≤ 5e-2 relative norm. bf16 rounds at other places in the two
  frameworks (XLA fuses bf16 elementwise chains, such as the causal
  conv's sum of shifted products, in f32).

The multi-pod step on mamba2 is held against the reference's
``build_train_step`` by tests/test_torch_train.py (its ``mamba2`` case),
which shares that file's reference subprocess.
"""
import dataclasses
import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import flatten_util

from repro import configs as ref_configs
from repro.models import ssm as ref_ssm
from repro.models import transformer as ref_tfm
from repro.models.common import init_params as ref_init
from repro.ps import zoo as ref_zoo
from repro_torch import configs, kernels
from repro_torch.kernels import fused_ce
from repro_torch.launch import train as launcher
from repro_torch.models import ssm
from repro_torch.models import transformer as tfm
from repro_torch.ps import zoo
from torch_serve_parity import decode_rows, walk_block

ARCH = "mamba2-780m"
TOLS = {"f32": (1e-5, 1e-4), "bf16": (1e-3, 5e-2)}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _cfgs(dt):
    jdt, tdt = DTYPES[dt]
    return (dataclasses.replace(ref_configs.get(ARCH).reduced,
                                compute_dtype=jdt),
            dataclasses.replace(configs.get(ARCH).reduced,
                                compute_dtype=tdt))


def _ref_params(cfg):
    return ref_init(ref_tfm.model_defs(cfg), jax.random.PRNGKey(0),
                    jnp.float32)


# ---------------------------------------------------------------------------
# the chunked scan and the block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,L,with_state", [(24, 16, False), (32, 16, False),
                                            (40, 16, True)])
def test_ssd_chunked_matches_reference(S, L, with_state):
    """y and the final state; S 24 pads to 32 with dt = 0."""
    rng = np.random.RandomState(S)
    B, H, P, N = 2, 8, 16, 16
    xh = rng.randn(B, S, H, P).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(B, S, H))).astype(np.float32)
    A = -np.exp(0.3 * rng.randn(H)).astype(np.float32)
    Bm, Cm = (rng.randn(B, S, N).astype(np.float32) for _ in range(2))
    state0 = (rng.randn(B, H, P, N).astype(np.float32) if with_state
              else None)
    args = (xh, dt, A, Bm, Cm)
    want_y, want_s = ref_ssm._ssd_chunked(
        *map(jnp.asarray, args), L,
        state0=None if state0 is None else jnp.asarray(state0))
    got_y, got_s = ssm._ssd_chunked(
        *map(torch.from_numpy, args), L,
        state0=None if state0 is None else torch.from_numpy(state0))
    assert got_y.shape == (B, S, H, P) and got_s.shape == (B, H, P, N)
    assert _rel(got_y.numpy(), want_y) <= TOLS["f32"][0]
    assert _rel(got_s.numpy(), want_s) <= TOLS["f32"][0]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_ssm_block_matches_reference(dt):
    rcfg, pcfg = _cfgs(dt)
    params = _ref_params(rcfg)["blocks"][0]["ssm"]
    layer = jax.tree_util.tree_map(lambda t: np.array(t[1]), params)
    rng = np.random.RandomState(4)
    x = rng.randn(2, 24, rcfg.d_model).astype(np.float32)
    want, _ = ref_ssm.ssm_block(
        rcfg, jax.tree_util.tree_map(jnp.asarray, layer),
        jnp.asarray(x).astype(rcfg.compute_dtype))
    got, cache = ssm.ssm_block(
        pcfg, {k: torch.from_numpy(v) for k, v in layer.items()},
        torch.from_numpy(x).to(pcfg.compute_dtype))
    assert cache is None and got.dtype == pcfg.compute_dtype
    tol = TOLS["f32"][0] if dt == "f32" else TOLS["bf16"][1]
    assert _rel(got.float().numpy(), np.asarray(want, np.float32)) <= tol


def _ssm_layer(pcfg):
    return {k: v[0].numpy() for k, v in
            _port_params(pcfg)["blocks"][0]["ssm"].items()}


def _ssm_cache(pcfg, B, rng=None):
    s = pcfg.ssm
    d_inner, H, conv_dim = ssm._dims(pcfg)
    shapes = {"conv": (B, s.d_conv - 1, conv_dim),
              "state": (B, H, s.head_dim, s.d_state)}
    draw = (lambda sh: np.zeros(sh, np.float32)) if rng is None else (
        lambda sh: rng.randn(*sh).astype(np.float32))
    return {k: draw(sh) for k, sh in shapes.items()}


def test_ssd_step_matches_reference():
    rng = np.random.RandomState(5)
    B, H, P, N = 3, 8, 16, 16
    args = (rng.randn(B, H, P, N), rng.randn(B, H, P),
            np.log1p(np.exp(rng.randn(B, H))),
            -np.exp(0.3 * rng.randn(H)), rng.randn(B, N), rng.randn(B, N))
    args = [a.astype(np.float32) for a in args]
    want_s, want_y = ref_ssm.ssd_step(*map(jnp.asarray, args))
    got_s, got_y = ssm.ssd_step(*map(torch.from_numpy, args))
    assert got_s.dtype == torch.float32 and got_y.shape == (B, H, P)
    assert _rel(got_s.numpy(), want_s) <= TOLS["f32"][0]
    assert _rel(got_y.numpy(), want_y) <= TOLS["f32"][0]


@pytest.mark.parametrize("n_prefill,S,rows", [(10, 14, None),
                                              (20, 23, None),
                                              (None, 1, [5, 40])])
def test_ssm_block_prefill_and_decode_match_reference(n_prefill, S, rows):
    """The prefill's conv history and final state (one chunk padded, two
    chunks), then each decode step's output, conv history and state; and
    one decode step from a random cache at per-row positions. f32 1e-5."""
    rcfg, pcfg = _cfgs("f32")
    x = np.random.RandomState(S).randn(2, S, pcfg.d_model).astype(
        np.float32)
    fns = (partial(ref_ssm.ssm_block, rcfg), partial(ssm.ssm_block, pcfg))
    if rows is None:
        walk_block(*fns, _ssm_layer(pcfg), x, _ssm_cache(pcfg, 2),
                   n_prefill)
    else:
        decode_rows(*fns, _ssm_layer(pcfg), x,
                    _ssm_cache(pcfg, 2, np.random.RandomState(1)), rows)


def _port_params(cfg):
    flat, _ = flatten_util.ravel_pytree(_ref_params(
        ref_configs.get(ARCH).reduced))
    return tfm.params_from_jax(np.asarray(flat), cfg, device="cpu")[0]


# ---------------------------------------------------------------------------
# the LM: loss and gradient, flat rows
# ---------------------------------------------------------------------------

def _batch(vocab, seed=3, B=2, S=24):
    rng = np.random.RandomState(seed)
    t = rng.randint(0, vocab, size=(B, S + 1))
    mask = (rng.rand(B, S) > 0.2).astype(np.float32)
    return t[:, :-1], t[:, 1:], mask


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_lm_loss_and_gradient_match_reference(dt):
    rcfg, pcfg = _cfgs(dt)
    flat, unravel = flatten_util.ravel_pytree(_ref_params(rcfg))
    tok, tgt, mask = _batch(rcfg.vocab_size)
    batch = {"tokens": jnp.asarray(tok), "targets": jnp.asarray(tgt),
             "mask": jnp.asarray(mask)}
    (want_loss, want_m), want_grad = jax.value_and_grad(
        lambda w: ref_tfm.lm_loss(rcfg, unravel(w), batch),
        has_aux=True)(flat)
    _, row = tfm.params_from_jax(np.asarray(flat), pcfg, device="cpu")
    leaf = row.to(torch.float32).requires_grad_(True)
    loss, metrics = tfm.lm_loss(pcfg, tfm.unflatten(leaf, pcfg), {
        "tokens": torch.from_numpy(tok), "targets": torch.from_numpy(tgt),
        "mask": torch.from_numpy(mask)})
    loss.backward()
    tol_loss, tol_grad = TOLS[dt]
    assert abs(loss.item() - float(want_loss)) <= tol_loss * abs(
        float(want_loss))
    assert metrics["tokens"].item() == float(want_m["tokens"])
    assert metrics["aux"].item() == float(want_m["aux"]) == 0.0
    # one argmax may flip where two bf16 logits nearly tie
    assert abs(metrics["accuracy"].item() - float(want_m["accuracy"])) <= \
        1.0 / float(want_m["tokens"]) + 1e-6
    assert _rel(leaf.grad.numpy(), want_grad) <= tol_grad


def _key(k):
    return k.key if hasattr(k, "key") else k.idx


def test_ravel_layout_is_the_reference_leaf_order():
    cfg = configs.get(ARCH).reduced
    want = [(tuple(_key(k) for k in path), leaf.shape) for path, leaf in
            jax.tree_util.tree_leaves_with_path(
                _ref_params(ref_configs.get(ARCH).reduced))]
    assert [(p, tuple(s)) for p, s in tfm.ravel_layout(cfg)] == want
    assert [p[-1] for p, _ in want[1:9]] == [
        "A_log", "D", "conv_b", "conv_w", "dt_bias", "norm", "w_in", "w_out"]
    full = configs.get(ARCH).config
    assert tfm.n_params(cfg) == 145_440
    assert tfm.n_params(full) == 780_148_992
    assert tfm.n_params(dataclasses.replace(full, n_layers=24)) == \
        428_690_304


def test_config_mirrors_the_reference():
    for which in ("config", "reduced"):
        got = getattr(configs.get(ARCH), which)
        want = getattr(ref_configs.get(ARCH), which)
        assert dataclasses.asdict(got.ssm) == dataclasses.asdict(want.ssm)
        for f in ("name", "n_layers", "d_model", "vocab_size", "pattern",
                  "tie_embeddings", "loss_chunk"):
            assert getattr(got, f) == getattr(want, f), (which, f)


def test_reduced_head_takes_the_bf16_tensor_core_route():
    """The CE kernel's bf16 route needs d a multiple of 16 (and aligned
    rows): the reduced config's d 64 and the full 1536 qualify."""
    for cfg in (configs.get(ARCH).reduced, configs.get(ARCH).config):
        assert cfg.compute_dtype == torch.bfloat16
        h = torch.zeros(48, cfg.d_model, dtype=torch.bfloat16)
        w = torch.zeros(64, cfg.d_model, dtype=torch.bfloat16).t()
        code, _ = fused_ce._cuda_args(h, w, torch.zeros(48,
                                                        dtype=torch.int64))
        assert code == 1


# ---------------------------------------------------------------------------
# the PS problem and the launcher
# ---------------------------------------------------------------------------

def test_make_zoo_lm_matches_reference():
    w0, ref_grad, ref_eval = ref_zoo.make_zoo_lm(ARCH)
    row, grad_fn, eval_fn = zoo.make_zoo_lm(ARCH, w0=w0, device="cpu")
    assert zoo.resolve(ARCH).kwargs == ref_zoo.resolve(ARCH).kwargs
    assert zoo.resolve(ARCH).factory == "repro_torch.ps.zoo:make_zoo_lm"
    np.testing.assert_array_equal(row.numpy(), w0)
    assert grad_fn.layer_sizes == ref_grad.layer_sizes
    for step, worker in ((0, 0), (0, 1)):
        got = grad_fn(row, step, worker)
        assert got.dtype == torch.float64 and got.shape == (w0.size,)
        assert _rel(got.numpy(), ref_grad(w0, step, worker)) <= \
            TOLS["bf16"][1], (step, worker)
    assert abs(eval_fn(row) - ref_eval(w0)) <= TOLS["bf16"][0] * ref_eval(w0)


def test_launcher_runs_mamba2_in_both_modes(capsys):
    kernels.reset_launch_counts()
    losses = launcher.main(["--arch", ARCH, "--reduced", "--n-pods", "2",
                            "--batch", "4", "--seq", "24", "--steps", "3",
                            "--log-every", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert len(losses) == 3 and all(map(math.isfinite, losses))
    assert out.splitlines()[0].startswith("exchange: schedule=psum")
    res = launcher.main(["--mode", "ps", "--model", ARCH, "--algorithm",
                         "sync_easgd", "--ps-workers", "2", "--ps-iters",
                         "6", "--bucket-bytes", "16384", "--eta", "0.05",
                         "--rho", "0.05", "--emulate", "none", "--device",
                         "cpu"])
    assert len(res) == 1 and bool(torch.isfinite(res[0].center).all())
    assert math.isfinite(res[0].final_metric) and res[0].final_metric < 7.0
    assert res[0].center.numel() == tfm.n_params(configs.get(ARCH).reduced)
    assert all(v == 0 for v in kernels.launch_counts().values())

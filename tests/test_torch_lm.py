"""The port's decoder LM (``repro_torch.models.transformer``) and its PS
problem (``repro_torch.ps.zoo.make_zoo_lm``) against the reference, on
reduced gemma3-4b with the reference's own params carried across by
``params_from_jax``.

Tolerances (measured on this CPU beside each):

* f32 compute on both sides: loss ≤ 1e-5 relative (7.6e-8), gradient
  ≤ 1e-4 relative norm (6.6e-7). Only the order of f32 sums differs.
* the config's bf16 compute: loss ≤ 1e-3 relative (2.9e-5), gradient
  ≤ 5e-2 relative norm (1.1e-2). bf16 rounds at other places in the two
  frameworks (XLA fuses bf16 elementwise chains in f32), and a one-ulp
  difference in a bf16 activation is 0.4 % of it.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import flatten_util

from repro import configs as ref_configs
from repro.models import transformer as ref_tfm
from repro.models.common import init_params as ref_init
from repro.ps import zoo as ref_zoo
from repro_torch import configs, kernels
from repro_torch.core.easgd import EASGDConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.common import init_params, tree_leaves_with_path
from repro_torch.ps import runtime, zoo

ARCH = "gemma3-4b"
TOLS = {"f32": (1e-5, 1e-4), "bf16": (1e-3, 5e-2)}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _batch(vocab, seed=3, B=2, S=24):
    rng = np.random.RandomState(seed)
    t = rng.randint(0, vocab, size=(B, S + 1))
    mask = (rng.rand(B, S) > 0.2).astype(np.float32)
    return t[:, :-1], t[:, 1:], mask


@pytest.fixture(scope="module", params=["f32", "bf16"])
def lm_case(request):
    """(dtype name, port cfg, flat reference row, reference loss, metrics
    and flat gradient) on one masked batch."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[request.param]
    rcfg = dataclasses.replace(ref_configs.get(ARCH).reduced,
                               compute_dtype=jdt)
    pcfg = dataclasses.replace(configs.get(ARCH).reduced, compute_dtype=tdt)
    params = ref_init(ref_tfm.model_defs(rcfg), jax.random.PRNGKey(0),
                      jnp.float32)
    flat, unravel = flatten_util.ravel_pytree(params)
    tok, tgt, mask = _batch(rcfg.vocab_size)
    batch = {"tokens": jnp.asarray(tok), "targets": jnp.asarray(tgt),
             "mask": jnp.asarray(mask)}
    (loss, metrics), grad = jax.value_and_grad(
        lambda w: ref_tfm.lm_loss(rcfg, unravel(w), batch),
        has_aux=True)(flat)
    return (request.param, pcfg, np.asarray(flat), float(loss),
            {k: float(v) for k, v in metrics.items()}, np.asarray(grad))


def test_lm_loss_and_gradient_match_reference(lm_case):
    dt, pcfg, flat, want_loss, want_metrics, want_grad = lm_case
    _, row = tfm.params_from_jax(flat, pcfg, device="cpu")
    leaf = row.to(torch.float32).requires_grad_(True)
    tok, tgt, mask = _batch(pcfg.vocab_size)
    loss, metrics = tfm.lm_loss(pcfg, tfm.unflatten(leaf, pcfg), {
        "tokens": torch.from_numpy(tok), "targets": torch.from_numpy(tgt),
        "mask": torch.from_numpy(mask)})
    loss.backward()
    tol_loss, tol_grad = TOLS[dt]
    assert abs(loss.item() - want_loss) <= tol_loss * abs(want_loss)
    assert metrics["tokens"].item() == want_metrics["tokens"]
    assert metrics["aux"].item() == want_metrics["aux"] == 0.0
    assert abs(metrics["ce"].item() - want_metrics["ce"]) <= \
        tol_loss * want_metrics["ce"]
    assert abs(metrics["accuracy"].item() - want_metrics["accuracy"]) <= \
        1.0 / want_metrics["tokens"]
    assert _rel(leaf.grad.numpy(), want_grad) <= tol_grad


def _ref_params():
    cfg = ref_configs.get(ARCH).reduced
    return ref_init(ref_tfm.model_defs(cfg), jax.random.PRNGKey(0),
                    jnp.float32)


def _key(k):
    return k.key if hasattr(k, "key") else k.idx


def test_ravel_layout_is_the_reference_leaf_order():
    cfg = configs.get(ARCH).reduced
    want = [(tuple(_key(k) for k in path), leaf.shape) for path, leaf in
            jax.tree_util.tree_leaves_with_path(_ref_params())]
    assert [(p, tuple(s)) for p, s in tfm.ravel_layout(cfg)] == want
    assert want[0][0] == ("blocks", 0, "attn", "k_norm")
    assert tfm.n_params(cfg) == 254_976
    assert tfm.n_params(configs.get(ARCH).config) == 3_879_925_248
    six = dataclasses.replace(configs.get(ARCH).config, n_layers=6)
    assert tfm.n_params(six) == 1_237_356_032


def test_params_from_jax_round_trips():
    cfg = configs.get(ARCH).reduced
    params = _ref_params()
    flat, _ = flatten_util.ravel_pytree(params)
    numpy_tree = jax.tree_util.tree_map(np.asarray, params)
    p_tree, row = tfm.params_from_jax(numpy_tree, cfg, device="cpu")
    np.testing.assert_array_equal(row.numpy(), np.asarray(flat, np.float64))
    p_row, row2 = tfm.params_from_jax(np.asarray(flat), cfg, device="cpu")
    assert torch.equal(row, row2)
    for (path, a), (_, b) in zip(tree_leaves_with_path(p_tree),
                                 tree_leaves_with_path(p_row)):
        assert torch.equal(a, b), path
    np.testing.assert_array_equal(
        p_tree["blocks"][0]["attn"]["wq"].numpy(),
        np.asarray(params["blocks"][0]["attn"]["wq"]))
    with pytest.raises(ValueError):
        tfm.params_from_jax(np.asarray(flat)[:-1], cfg, device="cpu")


def test_own_init_is_seeded_with_the_reference_std():
    cfg = configs.get(ARCH).reduced
    defs = tfm.model_defs(cfg)
    a = init_params(defs, torch.Generator().manual_seed(3))
    b = init_params(defs, torch.Generator().manual_seed(3))
    c = init_params(defs, torch.Generator().manual_seed(4))
    assert torch.equal(tfm.flatten_params(a), tfm.flatten_params(b))
    assert not torch.equal(tfm.flatten_params(a), tfm.flatten_params(c))
    ref = dict((tuple(_key(k) for k in p), np.asarray(v)) for p, v in
               jax.tree_util.tree_leaves_with_path(_ref_params()))
    std = {path: d.scale / math.sqrt(d.shape[-2] if len(d.shape) >= 2
                                     else d.shape[-1])
           for path, d in tree_leaves_with_path(defs) if d.init == "normal"}
    for path, leaf in tree_leaves_with_path(a):
        want = ref[path]
        if path not in std:
            assert not leaf.any() and not want.any(), path
            continue
        assert float(leaf.abs().max()) <= 2.0 * std[path] * (1 + 1e-6)
        if want.size >= 4096:
            assert abs(float(leaf.std()) / float(want.std()) - 1) < 0.1, path


def test_unported_kinds_and_arch_ids_raise():
    """Every arch id and layer kind of the reference is ported: an
    unknown id or kind raises ValueError, as the reference does."""
    with pytest.raises(ValueError):
        configs.get("no-such-arch")
    cfg = dataclasses.replace(configs.get(ARCH).reduced, pattern=("moe",))
    with pytest.raises(ValueError, match="unknown layer kind"):
        tfm.model_defs(cfg)


# ---------------------------------------------------------------------------
# the PS problem
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def zoo_pair():
    """The reference's problem and the port's, on the reference's w0."""
    ref = ref_zoo.make_zoo_lm(ARCH)
    port = zoo.make_zoo_lm(ARCH, w0=ref[0], device="cpu")
    return ref, port


def test_make_zoo_lm_matches_reference(zoo_pair):
    (w0, ref_grad, ref_eval), (row, grad_fn, eval_fn) = zoo_pair
    np.testing.assert_array_equal(row.numpy(), w0)
    assert grad_fn.layer_sizes == ref_grad.layer_sizes
    assert len(grad_fn.layer_sizes) == len(tfm.ravel_layout(
        configs.get(ARCH).reduced))
    # each call draws the next batch of worker stream 1000 + worker; a
    # different draw would move the gradient by O(1), not by 1e-2
    for step, worker in ((0, 0), (1, 0), (0, 1)):
        got = grad_fn(row, step, worker)
        want = ref_grad(w0, step, worker)
        assert got.dtype == torch.float64 and got.shape == (w0.size,)
        assert _rel(got.numpy(), want) <= TOLS["bf16"][1], (step, worker)
    assert abs(eval_fn(row) - ref_eval(w0)) <= TOLS["bf16"][0] * ref_eval(w0)


def test_zoo_lm_token_draws_are_the_reference_recipe():
    cfg = configs.get(ARCH).reduced
    row, grad_fn, _ = zoo.make_zoo_lm(ARCH, device="cpu")
    tok = np.random.RandomState(1000 + 5).randint(0, cfg.vocab_size,
                                                  size=(2, 25))
    leaf = row.to(torch.float32).requires_grad_(True)
    loss, _ = tfm.lm_loss(cfg, tfm.unflatten(leaf, cfg), {
        "tokens": torch.from_numpy(tok[:, :-1]),
        "targets": torch.from_numpy(tok[:, 1:]),
        "mask": torch.ones(2, 24)})
    loss.backward()
    assert torch.equal(grad_fn(row, 0, 5), leaf.grad.to(torch.float64))


@pytest.mark.parametrize("algo", ["sync_easgd", "sync_sgd"])
def test_short_ps_run_on_the_lm(algo):
    p, rounds = 2, 4
    cfg = runtime.PSConfig(algorithm=algo, n_workers=p,
                           total_iters=p * rounds, eval_every_iters=10**9,
                           bucket_bytes=65536)
    kernels.reset_launch_counts()
    res = runtime.run_ps(zoo.resolve(ARCH), EASGDConfig(eta=0.05, rho=0.05),
                         cfg, device="cpu")
    n = tfm.n_params(configs.get(ARCH).reduced)
    assert res.center.shape == (n,) and res.workers.shape == (p, n)
    assert bool(torch.isfinite(res.center).all())
    assert math.isfinite(res.final_metric) and res.final_metric < 7.0
    assert res.total_iters == p * rounds
    assert res.counters["sync_rounds"] == 2 * rounds     # ring: 2 per round
    assert all(v == 0 for v in kernels.launch_counts().values())

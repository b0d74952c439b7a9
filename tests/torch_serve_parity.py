"""Shared by the port's serving tests (tests/test_torch_serve*.py and the
block files tests/test_torch_{mla,ssm,rglru}.py): one layer's cache
branches in the reference and in the port, on the same numpy inputs.

``walk_block`` prefills the first rows of x into a zero cache, then
decodes the later rows one position at a time, in both packages, and
holds the output and every cache leaf after each call by relative norm.
``decode_rows`` runs one decode step from a random cache at per-row
positions (the ``BatchingEngine``'s case: rows at different places, some
past a ring buffer's wrap). Both at f32 compute, where only the order of
f32 sums differs: the limit is 1e-5 unless a test says otherwise.
``family_walk`` does the same for a whole reduced LM through
``prefill`` / ``decode_step`` (logits and caches at 1e-4).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as ref_configs
from repro.models import transformer as ref_tfm
from repro.models.common import init_params as ref_init
from repro_torch import configs
from repro_torch.models import transformer as tfm
from repro_torch.models.common import tree_leaves_with_path


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    den = np.linalg.norm(b)
    return float(np.linalg.norm(a - b) / den) if den else float(
        np.linalg.norm(a))


def _hold(what, y_p, y_r, c_p, c_r, tol) -> float:
    worst = rel(y_p.numpy(), y_r)
    assert worst <= tol, (what, "y", worst)
    assert set(c_p) == set(c_r), (what, sorted(c_p), sorted(c_r))
    for k in c_r:
        assert tuple(c_p[k].shape) == tuple(c_r[k].shape), (what, k)
        r = rel(c_p[k].float().numpy(), np.asarray(c_r[k], np.float32))
        assert r <= tol, (what, k, r)
        worst = max(worst, r)
    return worst


def walk_block(ref_fn, port_fn, params, x, cache, n_prefill, tol=1e-5):
    """``ref_fn`` / ``port_fn``: ``(params, x, positions, cache=,
    cache_pos=) -> (y, cache)`` (the reference's on jnp arrays, the
    port's on tensors); ``params`` / ``cache`` dicts of numpy arrays; x
    (B, S, d). Returns the largest relative norm read."""
    B, S, _ = x.shape
    rp = {k: jnp.asarray(v) for k, v in params.items()}
    pp = {k: torch.from_numpy(v) for k, v in params.items()}
    rc = {k: jnp.asarray(v) for k, v in cache.items()}
    pc = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    pos = np.broadcast_to(np.arange(n_prefill)[None], (B, n_prefill)).copy()
    y_r, rc = ref_fn(rp, jnp.asarray(x[:, :n_prefill]), jnp.asarray(pos),
                     cache=rc, cache_pos=None)
    with torch.inference_mode():
        y_p, pc = port_fn(pp, torch.from_numpy(x[:, :n_prefill]),
                          torch.from_numpy(pos), cache=pc, cache_pos=None)
    worst = _hold(f"prefill {n_prefill}", y_p, y_r, pc, rc, tol)
    for t in range(n_prefill, S):
        cp = np.full((B,), t, np.int32)
        y_r, rc = ref_fn(rp, jnp.asarray(x[:, t:t + 1]),
                         jnp.asarray(cp[:, None]), cache=rc,
                         cache_pos=jnp.asarray(cp))
        with torch.inference_mode():
            cpt = torch.from_numpy(cp.astype(np.int64))
            y_p, pc = port_fn(pp, torch.from_numpy(x[:, t:t + 1]),
                              cpt[:, None], cache=pc, cache_pos=cpt)
        worst = max(worst, _hold(f"decode {t}", y_p, y_r, pc, rc, tol))
    return worst


def decode_rows(ref_fn, port_fn, params, x1, cache, cache_pos, tol=1e-5):
    """One decode step of x1 (B, 1, d) from ``cache`` at the per-row
    ``cache_pos`` (B,); returns the largest relative norm read."""
    rp = {k: jnp.asarray(v) for k, v in params.items()}
    pp = {k: torch.from_numpy(v) for k, v in params.items()}
    cp = np.asarray(cache_pos, np.int32)
    y_r, rc = ref_fn(rp, jnp.asarray(x1), jnp.asarray(cp[:, None]),
                     cache={k: jnp.asarray(v) for k, v in cache.items()},
                     cache_pos=jnp.asarray(cp))
    with torch.inference_mode():
        cpt = torch.from_numpy(cp.astype(np.int64))
        y_p, pc = port_fn(pp, torch.from_numpy(x1), cpt[:, None],
                          cache={k: torch.from_numpy(v.copy())
                                 for k, v in cache.items()},
                          cache_pos=cpt)
    return _hold(f"rows at {list(cp)}", y_p, y_r, pc, rc, tol)


# ---------------------------------------------------------------------------
# a reduced LM's prefill and decode (tests/test_torch_serve_families.py,
# tests/test_torch_serve_variants.py)
# ---------------------------------------------------------------------------

FAMILY_B, FAMILY_MAX_LEN = 2, 20


def family_cfgs(arch, capacity8):
    """The reference's and the port's reduced config at f32 compute; with
    ``capacity8`` the MoE capacity factor 8 (no drops)."""
    rcfg = dataclasses.replace(ref_configs.get(arch).reduced,
                               compute_dtype=jnp.float32)
    pcfg = dataclasses.replace(configs.get(arch).reduced,
                               compute_dtype=torch.float32)
    if capacity8:
        rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(
            rcfg.moe, capacity_factor=8.0))
        pcfg = dataclasses.replace(pcfg, moe=dataclasses.replace(
            pcfg.moe, capacity_factor=8.0))
    return rcfg, pcfg


def _extras(cfg, rng, n_prefill, B, S):
    """Per call: the prefill's and each decode step's modality extras
    (distinct t / h / w M-RoPE positions, the patch embeddings)."""
    if cfg.mrope_sections is None:
        return [{}] * (S - n_prefill + 1)
    s = np.arange(S)
    pos = np.broadcast_to(np.stack([s, s // 6, s % 6])[:, None],
                          (3, B, S)).astype(np.int32)
    out = [{"mrope_positions": pos[..., :n_prefill].copy(),
            "patch_embeds": rng.randn(B, cfg.patch_embed_tokens,
                                      cfg.d_model).astype(np.float32)}]
    return out + [{"mrope_positions": pos[..., t:t + 1].copy()}
                  for t in range(n_prefill, S)]


def _hold_caches(got, want, what) -> float:
    g = tree_leaves_with_path(tfm.caches_to_numpy(got))
    w = tree_leaves_with_path(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), want))
    assert [p for p, _ in g] == [p for p, _ in w], what
    worst = 0.0
    for (path, a), (_, b) in zip(g, w):
        assert a.shape == b.shape, (what, path)
        r = rel(a, b)
        assert r <= 1e-4, (what, path, r)
        worst = max(worst, r)
    return worst


def family_walk(arch, n_prefill, capacity8) -> tuple:
    """Prefill ``n_prefill`` tokens of two rows and decode them one at a
    time to ``FAMILY_MAX_LEN − 1`` in both packages, on the reference's
    ``init_params``; holds every call's logits (rtol = atol = 1e-4) and
    every cache leaf (relative norm 1e-4). Returns the largest |logit
    error| and cache relative norm read."""
    B, S = FAMILY_B, FAMILY_MAX_LEN
    rcfg, pcfg = family_cfgs(arch, capacity8)
    params = ref_init(ref_tfm.model_defs(rcfg), jax.random.PRNGKey(0),
                      jnp.float32)
    pp, _ = tfm.params_from_jax(params, pcfg, device="cpu")
    rng = np.random.RandomState(1)
    tok = rng.randint(0, rcfg.vocab_size, (B, S))
    extras = _extras(pcfg, rng, n_prefill, B, S)

    def jx(d):
        return {k: jnp.asarray(v) for k, v in d.items()}

    def tx(d):
        return {k: torch.from_numpy(v) for k, v in d.items()}

    prefill = jax.jit(lambda p, t, c, ex: ref_tfm.prefill(rcfg, p, t, c,
                                                          **ex))
    decode = jax.jit(lambda p, t, c, pos, ex: ref_tfm.decode_step(
        rcfg, p, t, c, pos, **ex))
    want, rc = prefill(params, jnp.asarray(tok[:, :n_prefill]),
                       ref_tfm.init_caches(rcfg, B, S), jx(extras[0]))
    with torch.inference_mode():
        got, pc = tfm.prefill(pcfg, pp, torch.from_numpy(tok[:, :n_prefill]),
                              tfm.init_caches(pcfg, B, S, device="cpu"),
                              **tx(extras[0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    err = float(np.abs(got.numpy() - np.asarray(want)).max())
    worst = _hold_caches(pc, rc, "prefill")
    for i, t in enumerate(range(n_prefill, S), start=1):
        pos = np.full((B,), t, np.int32)
        want, rc = decode(params, jnp.asarray(tok[:, t:t + 1]), rc,
                          jnp.asarray(pos), jx(extras[i]))
        with torch.inference_mode():
            got, pc = tfm.decode_step(
                pcfg, pp, torch.from_numpy(tok[:, t:t + 1]), pc,
                torch.from_numpy(pos.astype(np.int64)), **tx(extras[i]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)
        err = max(err, float(np.abs(got.numpy() - np.asarray(want)).max()))
        worst = max(worst, _hold_caches(pc, rc, f"decode at {t}"))
    return err, worst

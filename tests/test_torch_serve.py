"""Serving in the port (``repro_torch.models.attention``'s cache paths,
``transformer.cast_for_serving``, the entry points' device rule) against
the reference's ``repro.models.attention``, on numpy-seeded inputs.

Held, at f32 (only the order of f32 sums differs), by relative norm:

* ``decode_attention`` (GQA, a ``(B, S)`` or ``(S,)`` validity mask,
  ``softcap`` on the scores, Dv apart from D) 1e-5; with a bf16 cache
  1e-2, the bf16 limit: on the CPU the port's bf16 scores are rounded to
  bf16 (the module docstring), the reference's are f32;
* ``blocked_attention`` with ``q_offset``, ``kv_valid_len``, ``cap``,
  a window and ragged tiles, 1e-5;
* ``attention_block``'s two cache branches on gemma3-4b's reduced layer
  (window 8), global and local, prompts shorter than, one short of and
  longer than the window (the roll), then decoding across the ring
  buffer's wrap: the output and the k / v caches after every call, 1e-5;
  one decode step from a random cache at per-row positions, before and
  past the wrap, 1e-5.

``cast_for_serving`` is bit for bit the per-use cast: every reduced
config at its bf16 compute gives the same logits and caches from the
leaves cast once as from the f32 masters. An entry point called without
a device on a machine without a GPU raises.

Readings on this CPU: decode_attention ≤ 1.3e-7 (bf16 3.4e-3),
blocked_attention ≤ 1.4e-7, attention_block ≤ 3.5e-7.
"""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from functools import partial

from repro import configs as ref_configs
from repro.models import attention as ref_attn
from repro_torch import configs
from repro_torch.models import attention, transformer as tfm
from repro_torch.models.common import init_params, tree_leaves_with_path
from repro_torch.runtime import serve
from torch_serve_parity import decode_rows, rel, walk_block

ARCH = "gemma3-4b"
ARCH_IDS = sorted(configs.ARCHS)


def _f32_cfgs(arch=ARCH):
    return (dataclasses.replace(ref_configs.get(arch).reduced,
                                compute_dtype=jnp.float32),
            dataclasses.replace(configs.get(arch).reduced,
                                compute_dtype=torch.float32))


# ---------------------------------------------------------------------------
# decode_attention and blocked_attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt,mask_dim,cap,Dv", [
    ("f32", 2, 0.0, 16), ("f32", 1, 0.0, 16), ("f32", 2, 3.0, 16),
    ("f32", 2, 0.0, 8), ("bf16", 2, 0.0, 16)])
def test_decode_attention_matches_reference(dt, mask_dim, cap, Dv):
    rng = np.random.RandomState(mask_dim + int(cap) + Dv)
    B, S, H, KVH, D = 3, 20, 4, 2, 16
    q = rng.randn(B, 1, H, D).astype(np.float32)
    k = rng.randn(B, S, KVH, D).astype(np.float32)
    v = rng.randn(B, S, KVH, Dv).astype(np.float32)
    valid = rng.rand(B, S) > 0.3 if mask_dim == 2 else rng.rand(S) > 0.3
    valid[..., 0] = True
    jdt, tdt = ((jnp.float32, torch.float32) if dt == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    want = ref_attn.decode_attention(
        jnp.asarray(q).astype(jdt), jnp.asarray(k).astype(jdt),
        jnp.asarray(v).astype(jdt), jnp.asarray(valid), cap=cap)
    got = attention.decode_attention(
        torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt),
        torch.from_numpy(v).to(tdt), torch.from_numpy(valid), cap=cap)
    assert got.shape == (B, 1, H, Dv) and got.dtype == torch.float32
    assert rel(got.numpy(), np.asarray(want, np.float32)) <= (
        1e-5 if dt == "f32" else 1e-2)


@pytest.mark.parametrize("Sq,Skv,causal,window,q_offset,kv_valid,cap,qb,kb", [
    (12, 12, True, 0, 0, None, 0.0, 8, 8),
    (12, 12, True, 5, 0, None, 0.0, 4, 8),
    (6, 20, True, 0, 14, None, 0.0, 4, 8),
    (12, 20, False, 0, 0, 13, 0.0, 8, 8),
    (12, 12, True, 0, 0, None, 2.0, 8, 8),
    (10, 17, True, 4, 7, 15, 1.5, 4, 4)])
def test_blocked_attention_matches_reference(Sq, Skv, causal, window,
                                             q_offset, kv_valid, cap, qb,
                                             kb):
    rng = np.random.RandomState(Sq + Skv + window)
    B, H, KVH, D = 2, 4, 2, 16
    q = rng.randn(B, Sq, H, D).astype(np.float32)
    k = rng.randn(B, Skv, KVH, D).astype(np.float32)
    v = rng.randn(B, Skv, KVH, D).astype(np.float32)
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              kv_valid_len=kv_valid, q_block=qb, kv_block=kb, cap=cap)
    want = ref_attn.blocked_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), **kw)
    got = attention.blocked_attention(torch.from_numpy(q),
                                      torch.from_numpy(k),
                                      torch.from_numpy(v), **kw)
    assert got.shape == (B, Sq, H, D)
    assert rel(got.numpy(), np.asarray(want)) <= 1e-5


# ---------------------------------------------------------------------------
# attention_block's cache branches
# ---------------------------------------------------------------------------

def _layer(cfg, seed=0):
    rng = np.random.RandomState(seed)
    p = {}
    for name, d in sorted(attention.attention_defs(cfg).items()):
        if d.init == "zeros":
            p[name] = (0.1 * rng.randn(*d.shape)).astype(np.float32)
        else:
            p[name] = (rng.randn(*d.shape) / math.sqrt(d.shape[0])).astype(
                np.float32)
    return p


def _kv_cache(cfg, B, Sc, rng=None):
    shape = (B, Sc, cfg.n_kv_heads, cfg.resolved_head_dim)
    if rng is None:
        return {"k": np.zeros(shape, np.float32),
                "v": np.zeros(shape, np.float32)}
    return {"k": rng.randn(*shape).astype(np.float32),
            "v": rng.randn(*shape).astype(np.float32)}


def _fns(rcfg, pcfg, kind):
    return (partial(ref_attn.attention_block, rcfg, kind=kind),
            partial(attention.attention_block, pcfg, kind=kind))


@pytest.mark.parametrize("kind,n_prefill,max_len", [
    ("local", 5, 16), ("local", 7, 16), ("local", 11, 19),
    ("local", 8, 12), ("attn", 5, 14), ("attn", 14, 14)])
def test_attention_block_prefill_and_decode_match_reference(kind, n_prefill,
                                                            max_len):
    """Prefill n_prefill positions, decode to max_len − 1: a local layer
    (window 8) before and across the wrap, and after a prompt longer than
    the window (the roll); a global layer whose prompt fills its cache."""
    rcfg, pcfg = _f32_cfgs()
    Sc = min(pcfg.window, max_len) if kind == "local" else max_len
    B = 2
    x = np.random.RandomState(n_prefill).randn(
        B, max_len, pcfg.d_model).astype(np.float32)
    ref_fn, port_fn = _fns(rcfg, pcfg, kind)
    walk_block(ref_fn, port_fn, _layer(pcfg), x, _kv_cache(pcfg, B, Sc),
               n_prefill)


@pytest.mark.parametrize("kind,Sc,rows", [
    ("local", 8, [3, 9, 16]), ("local", 8, [7, 8, 0]),
    ("attn", 12, [2, 11, 5])])
def test_attention_decode_at_per_row_positions_matches_reference(kind, Sc,
                                                                 rows):
    rcfg, pcfg = _f32_cfgs()
    rng = np.random.RandomState(Sc + rows[0])
    x1 = rng.randn(len(rows), 1, pcfg.d_model).astype(np.float32)
    ref_fn, port_fn = _fns(rcfg, pcfg, kind)
    decode_rows(ref_fn, port_fn, _layer(pcfg, 1), x1,
                _kv_cache(pcfg, len(rows), Sc, rng), rows)


# ---------------------------------------------------------------------------
# leaves cast once; the device rule
# ---------------------------------------------------------------------------

def _run(cfg, params, tokens, n_prefill, max_len):
    with torch.inference_mode():
        caches = tfm.init_caches(cfg, tokens.shape[0], max_len,
                                 device="cpu")
        out, caches = tfm.prefill(cfg, params, tokens[:, :n_prefill],
                                  caches)
        outs = [out]
        for t in range(n_prefill, tokens.shape[1]):
            pos = torch.full((tokens.shape[0],), t)
            out, caches = tfm.decode_step(cfg, params, tokens[:, t:t + 1],
                                          caches, pos)
            outs.append(out)
    return outs, caches


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_leaves_cast_once_are_bit_for_bit_the_per_use_cast(arch):
    cfg = configs.get(arch).reduced            # bf16 compute
    params = init_params(tfm.model_defs(cfg),
                         torch.Generator().manual_seed(0), device="cpu")
    served = tfm.cast_for_serving(cfg, params)
    for path, leaf in tree_leaves_with_path(served):
        want = (torch.float32 if path[-1] in tfm.F32_LEAVES
                or path == ("unembed",) else cfg.compute_dtype)
        assert leaf.dtype == want, (path, leaf.dtype)
    tokens = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg.vocab_size, size=(2, 11)))
    want_out, want_c = _run(cfg, params, tokens, 7, 12)
    got_out, got_c = _run(cfg, served, tokens, 7, 12)
    for a, b in zip(got_out, want_out):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    for (pa, a), (pb, b) in zip(tree_leaves_with_path(got_c),
                                tree_leaves_with_path(want_c)):
        assert pa == pb and a.dtype == b.dtype and torch.equal(a, b), pa


def test_entry_points_without_a_device_need_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: device None means it")
    cfg = configs.get(ARCH).reduced
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.build_serve_steps(cfg, batch=2, max_len=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.BatchingEngine(cfg, {}, batch=2, max_len=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfm.init_caches(cfg, 2, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfm.caches_from_jax({"stacked": (), "rem": ()}, cfg)

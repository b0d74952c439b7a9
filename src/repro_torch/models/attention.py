"""Attention: RoPE, GQA, qk-norm, causal and sliding window masks, and
serving with a cache (the port of ``repro/models/attention.py``).

``flash_attention_train`` is the reference's custom-VJP flash attention:
``kernels.flash_attention.FlashAttention``, whose forward and backward
launch the CUDA kernels for tensors on the card and run the plain versions
(eager ports of ``_flash_fwd_impl`` / ``_flash_bwd_impl``) on the CPU.

Serving (``attention_block`` with a cache):

* prefill runs ``kernels.flash_attention.flash_attention_fwd`` directly,
  outside autograd (the reference's ``blocked_attention(q, k, v,
  causal=True, window=window)`` at ``q_offset`` 0, no ``kv_valid_len``
  and cap 0 is that function), and fills the cache;
* decode writes k / v at ``cache_pos`` (for a ``local`` layer into a ring
  buffer of ``window`` slots at ``cache_pos % Sc``) and runs
  ``decode_attention``, torch products as the reference leaves them to
  XLA.

Both write the cache tensors they are given in place and return them: the
reference donates its caches to the decode step, so no caller may read a
cache it has passed on. A decode position at or past a global layer's
cache length is out of range (the reference drops such a write).

``decode_attention`` never makes an f32 copy of the cache (at gemma3-4b's
``decode_32k`` shape that copy would be 21 GB). The scores ``q·kᵀ`` and
the context ``p·v`` are products of the cache's dtype with an f32 result,
one per KV head on strided views of the cache: on the card a bf16 cache
takes ``aten::bmm.dtype`` (bf16 operands, f32 accumulation and result:
the reference's ``preferred_element_type=f32``) where this torch has it.
Where it has not, and on the CPU, a bf16 product's result is rounded to
bf16 before it is widened, so bf16 scores then carry one bf16 rounding
(relative 2^-8) that the reference's do not. f32 caches take f32
products on every route.

``blocked_attention`` is the reference's full-signature plain attention
(``q_offset``, ``kv_valid_len``, ``cap``), the serving oracle.

On a mesh (``models.tp``) whose ``model`` axis splits the q heads, the
block is a model-parallel region: the input enters through ``copy_in``,
each rank projects, attends and caches its own heads, and the output
projection's partial sum leaves through ``reduce_out``. Where ``model``
splits the q heads but not the kv heads (GQA with ``n_kv_heads`` not a
multiple of it), the rank takes the kv heads its q heads read
(``Layout.kv_index``) from the replicated projection; serving, its cache
holds every kv head, so it projects them all, and a decode step gathers
every head's query over ``model``, attends and keeps its own heads.
``sctx.shard`` stands at the reference's points.

Flash-decoding: where the cache specs split a cache's time dim
(``Layout.time_split``), the rank holds one block of it. A decode step
writes the new token's k / v only on the rank whose block holds its
global slot, masks on global slot indices, and ``decode_partials`` leaves
the softmax open (its max, its sum over valid slots and the
un-normalised context) for ``tp.softmax_combine``; a block with no valid
slot yet weighs nothing. The prefill attends whole, as on one device,
and each rank writes the part of the (rolled, for a ring) window its
block covers (``fill_block``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.flash_attention import (  # noqa: F401
    NEG_INF, FlashAttention, _tile_mask)
from repro_torch.models import sctx, tp
from repro_torch.models.common import ModelConfig, ParamDef, rms_norm, softcap


def _rope_inv_freq(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, D); positions: broadcastable to (..., S). Rotate-half,
    f32 inside, cast back to x's dtype."""
    half = x.shape[-1] // 2
    inv = _rope_inv_freq(x.shape[-1], theta, x.device)
    ang = positions[..., None].to(torch.float32) * inv      # (..., S, half)
    sin = torch.sin(ang)[..., None, :]                      # (..., S, 1, half)
    cos = torch.cos(ang)[..., None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x, positions, theta: float, sections):
    """Qwen2-VL multimodal RoPE. x: (..., S, H, D); positions: (3, ..., S)
    for the (t, h, w) streams; ``sections`` splits the rotary half-dim
    across them: channel j turns by the stream whose section holds it.
    f32 inside, cast back to x's dtype."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {tuple(sections)} do not sum to "
                         f"half the head dim, {half}")
    inv = _rope_inv_freq(x.shape[-1], theta, x.device)      # (half,)
    # each channel's stream, made on the host: repeat_interleave with a
    # tensor of counts reads them back from the device
    sec_id = torch.tensor([i for i, n in enumerate(sections)
                           for _ in range(n)], device=x.device)  # (half,)
    pos = positions[sec_id].movedim(0, -1)                  # (..., S, half)
    ang = pos.to(torch.float32) * inv
    sin = torch.sin(ang)[..., None, :]
    cos = torch.cos(ang)[..., None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def flash_attention_train(q, k, v, *, causal=True, window=0, q_block=512,
                          kv_block=1024):
    """Training-path attention with the flash backward. q: (B, S, H, Dqk);
    k: (B, S, KVH, Dqk); v: (B, S, KVH, Dv), where Dv may differ from Dqk
    (MLA); the output is (B, S, H, Dv) and the scale ``1/√Dqk``. ``q_block``
    / ``kv_block`` are the plain
    version's tiles; the kernels tile on their own and mask ragged tails,
    so, unlike the reference, a non-causal call needs no padding rule."""
    return FlashAttention.apply(q.contiguous(), k.contiguous(),
                                v.contiguous(), bool(causal), int(window),
                                int(q_block), int(kv_block))


def blocked_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                      kv_valid_len=None, q_block=512, kv_block=1024,
                      cap=0.0):
    """Online-softmax attention over (q_block × kv_block) tiles, the
    reference's ``blocked_attention``: the attention kernel's plain
    version with the serving keywords. q: (B, Sq, H, D); k: (B, Skv, KVH,
    D); v: (B, Skv, KVH, Dv). ``window`` 0 = none, else a sliding window;
    ``q_offset`` the absolute position of q[0]; ``kv_valid_len`` masks kv
    positions at or past it; ``cap`` soft-caps the scores. Scores and
    accumulators are f32, ``p`` is rounded to v's dtype before ``p·v``;
    the output is in q's dtype."""
    return fa.flash_attention_fwd_ref(
        q, k, v, causal, window, q_block, kv_block, q_offset=q_offset,
        kv_valid_len=kv_valid_len, cap=cap)[0]


def product_f32(a, b):
    """``torch.bmm(a, b)`` with an f32 result, without an f32 copy of
    either operand: f32 operands give an f32 product; bf16 ones on the
    card ``aten::bmm.dtype`` (f32 accumulation and result) where this
    torch has it, else the bf16 product widened (see the module
    docstring)."""
    if a.dtype != torch.float32 and a.device.type == "cuda" \
            and hasattr(torch.ops.aten.bmm, "dtype"):
        return torch.ops.aten.bmm.dtype(a, b, torch.float32)
    return torch.bmm(a, b).float()


def _decode_scores(q, k_cache, valid_mask, cap):
    """(B, KVH, G, S) f32 scores of q (B, 1, H, D) against the cache, soft-
    capped, the slots outside ``valid_mask`` at ``NEG_INF``."""
    B, _, H, D = q.shape
    KVH = k_cache.shape[2]
    qg = q.reshape(B, KVH, H // KVH, D).to(k_cache.dtype)
    # one product per KV head, on the cache's strided (B, D, S) views
    s = torch.stack([product_f32(qg[:, h], k_cache[:, :, h].transpose(1, 2))
                     for h in range(KVH)], dim=1) * (1.0 / math.sqrt(D))
    s = softcap(s, cap)
    if valid_mask.dim() == 1:
        valid_mask = valid_mask[None]
    return torch.where(valid_mask[:, None, None, :], s, NEG_INF)


def _decode_context(p, v_cache):
    """(B, KVH, G, Dv) f32: the weights p (B, KVH, G, S), in the cache's
    dtype, times the cache."""
    return torch.stack([product_f32(p[:, h], v_cache[:, :, h])
                        for h in range(v_cache.shape[2])], dim=1)


def decode_attention(q, k_cache, v_cache, valid_mask, cap=0.0):
    """Single-position attention against a cache. q: (B, 1, H, D);
    k_cache: (B, S, KVH, D); v_cache: (B, S, KVH, Dv); valid_mask: (B, S)
    or (S,) bool, the slots that take part. Returns (B, 1, H, Dv) f32.
    Scores are f32 (see the module docstring), soft-capped by ``cap``; the
    softmax is f32 and ``p`` is rounded to the cache's dtype before
    ``p·v``."""
    B, _, H, _ = q.shape
    s = _decode_scores(q, k_cache, valid_mask, cap)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    return _decode_context(p, v_cache).reshape(B, 1, H, v_cache.shape[-1])


def partial_softmax(s, valid):
    """The open softmax of scores ``s`` (..., S) over one block of the
    time dim, ``valid`` (broadcast to s) the slots that take part:
    ``(m, l, e)``, the running max (...), the sum of ``e = e^{s−m}`` over
    the valid slots (...) and ``e`` (..., S), 0 off them. A block with no
    valid slot has ``m = NEG_INF`` and ``l = 0``: it weighs nothing in
    ``tp.softmax_combine``, where a plain softmax of its masked scores
    would spread its weight evenly."""
    m = s.amax(dim=-1)
    e = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    return m, e.sum(dim=-1), e


def decode_partials(q, k_cache, v_cache, valid_mask, cap=0.0):
    """``decode_attention`` over one block of the cache's time dim with
    the softmax left open (flash-decoding): ``(m, l, o)``, each
    (B, KVH, G[, Dv]), ``o`` the un-normalised ``Σ e^{s−m} v`` with the
    weights rounded to the cache's dtype; ``tp.softmax_combine`` finishes
    them over the ranks' blocks."""
    s = _decode_scores(q, k_cache, valid_mask, cap)
    valid = valid_mask if valid_mask.dim() == 2 else valid_mask[None]
    m, l, e = partial_softmax(s, valid[:, None, None, :])
    return m, l, _decode_context(e.to(v_cache.dtype), v_cache)


def write_slot(cache, pos, value, split=None):
    """Write ``value`` (B, ...) into row b's slot ``pos[b]`` of ``cache``
    (B, Sc, ...), in place. With a time ``split`` (``tp.TimeSplit``) the
    cache is this rank's block and ``pos`` a global slot: only the rank
    whose block holds it writes."""
    bidx = torch.arange(cache.shape[0], device=cache.device)
    value = value.to(cache.dtype)
    if split is None:
        cache[bidx, pos] = value
        return
    off, blk = split.offset, split.block
    own = (pos >= off) & (pos < off + blk)
    local = (pos - off).clamp(0, blk - 1)
    keep = own.reshape((-1,) + (1,) * (value.dim() - 1))
    cache[bidx, local] = torch.where(keep, value, cache[bidx, local])


def fill_block(cache, src, split=None):
    """A prefill's write of ``src`` (B, n, ...), the values of global slots
    ``[0, n)``, into ``cache`` (B, Sc, ...), in place: with a time
    ``split`` the part of them that this rank's block covers."""
    off = split.offset if split is not None else 0
    n = max(0, min(cache.shape[1], src.shape[1] - off))
    if n:
        cache[:, :n] = src[:, off:off + n]


def slot_positions(n: int, split, device):
    """The global slot indices of a cache's ``n`` local slots."""
    off = split.offset if split is not None else 0
    return off + torch.arange(n, device=device)


def attention_defs(cfg: ModelConfig) -> dict:
    D = cfg.resolved_head_dim
    d = cfg.d_model
    H, KVH = cfg.n_heads, cfg.n_kv_heads
    defs = {
        "wq": ParamDef((d, H, D), ("embed", "q_heads", "head_dim")),
        "wk": ParamDef((d, KVH, D), ("embed", "kv_heads", "head_dim")),
        "wv": ParamDef((d, KVH, D), ("embed", "kv_heads", "head_dim")),
        "wo": ParamDef((H, D, d), ("q_heads", "head_dim", "embed_out")),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((H, D), ("q_heads", "head_dim"), init="zeros")
        defs["bk"] = ParamDef((KVH, D), ("kv_heads", "head_dim"),
                              init="zeros")
        defs["bv"] = ParamDef((KVH, D), ("kv_heads", "head_dim"),
                              init="zeros")
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef((D,), ("head_dim",), init="zeros")
        defs["k_norm"] = ParamDef((D,), ("head_dim",), init="zeros")
    return defs


def _tp_inputs(cfg: ModelConfig, p, all_kv: bool = False):
    """The params a model-parallel attention block reads: the replicated
    ones (qk-norm scales; kv projections and biases that ``model`` does not
    split, cut to the kv heads this rank's q heads read unless ``all_kv``)
    through ``copy_in``, whose backward sums their partial gradients over
    the ranks' heads. Unchanged without such a layout."""
    lay = tp.current()
    if lay is None or not lay.heads:
        return p
    p = dict(p)
    for name in ("q_norm", "k_norm"):
        if name in p:
            p[name] = tp.copy_in(p[name])
    if not lay.kv_heads and not all_kv:
        idx = lay.kv_index()
        for name, dim in (("wk", 1), ("wv", 1), ("bk", 0), ("bv", 0)):
            if name in p:
                p[name] = tp.copy_in(p[name]).index_select(
                    dim, torch.tensor(idx, device=p[name].device))
    return p


def _project_qkv(cfg: ModelConfig, p, x, positions, *, theta,
                 mrope_positions=None, all_kv=False):
    cd = cfg.compute_dtype
    p = _tp_inputs(cfg, p, all_kv)
    if tp.current() is not None and tp.current().heads:
        x = tp.copy_in(x)
    q = sctx.shard(torch.einsum("bsd,dhk->bshk", x, p["wq"].to(cd)),
                   "batch", "seq", "heads", "head_dim")
    k = sctx.shard(torch.einsum("bsd,dhk->bshk", x, p["wk"].to(cd)),
                   "batch", "seq", "kv_heads", "head_dim")
    v = sctx.shard(torch.einsum("bsd,dhk->bshk", x, p["wv"].to(cd)),
                   "batch", "seq", "kv_heads", "head_dim")
    if cfg.qkv_bias:
        q = q + p["bq"].to(cd)
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if cfg.mrope_sections is not None and mrope_positions is not None:
        q = apply_mrope(q, mrope_positions, theta, cfg.mrope_sections)
        k = apply_mrope(k, mrope_positions, theta, cfg.mrope_sections)
    else:
        q = apply_rope(q, positions, theta)
        k = apply_rope(k, positions, theta)
    return q, k, v


def _decode(cfg: ModelConfig, q, k, v, cache, cache_pos, window, split,
            kv_whole):
    """A decode step's attention (B, 1, H_rank, Dv) f32, writing k / v into
    the cache in place: on the whole cache, or with a time ``split`` on the
    rank's block, finished over its axes by ``tp.softmax_combine``. With
    ``kv_whole`` every rank attends with every q head (gathered over
    ``model``: the cache block holds every kv head) and keeps its own."""
    k_c, v_c = cache["k"], cache["v"]
    Sc = split.length if split else k_c.shape[1]
    pos = cache_pos.to(torch.int64)
    slot = pos % Sc if window else pos
    write_slot(k_c, slot, k[:, 0], split)
    write_slot(v_c, slot, v[:, 0], split)
    valid = slot_positions(k_c.shape[1], split, q.device)[None, :] \
        <= pos[:, None]
    if window:
        # ring buffer: before the wrap only slots 0..pos are written;
        # after it every slot holds one of the last Sc tokens
        valid = valid | (pos[:, None] >= Sc)
    cd = cfg.compute_dtype
    lay = tp.current()
    hl = q.shape[2]
    if kv_whole:
        q = tp.gather_dim(q, 2, lay.model_group)
    if split is None:
        out = decode_attention(q, k_c.to(cd), v_c.to(cd), valid, cap=0.0)
    else:
        out = tp.softmax_combine(*decode_partials(
            q, k_c.to(cd), v_c.to(cd), valid), split)
        out = out.reshape(q.shape[:3] + (v_c.shape[-1],))
    if kv_whole:
        out = out.narrow(2, lay.model_rank * hl, hl)
    return out


def attention_block(cfg: ModelConfig, p, x, positions, *, kind="attn",
                    cache=None, cache_pos=None, mrope_positions=None):
    """One attention block -> ``(y, cache)``.

    Modes, as the reference's:
      * ``cache`` None: training / teacher-forced forward (``(y, None)``);
      * ``cache`` given and S 1: decode, writing and reading the cache at
        ``cache_pos`` (B,);
      * ``cache`` given and S longer: prefill, filling the cache.

    cache: ``{k: (B, Sc, KVH, D), v: ...}``; for a ``local`` layer Sc is
    the ring buffer's ``window`` slots, for a global one the longest
    context. Both cache branches write it in place (module docstring)."""
    cd = cfg.compute_dtype
    window = cfg.window if kind == "local" else 0
    theta = cfg.rope_theta if kind == "local" or not cfg.rope_theta_global \
        else cfg.rope_theta_global
    lay = tp.current()
    # serving on a mesh whose model axis splits the q heads but not the kv
    # heads: the cache holds every kv head, so the rank projects them all
    kv_whole = cache is not None and lay is not None and lay.heads \
        and not lay.kv_heads
    split = lay.time_split(kind) if cache is not None and lay is not None \
        else None
    q, k, v = _project_qkv(cfg, p, x, positions, theta=theta,
                           mrope_positions=mrope_positions, all_kv=kv_whole)
    if cache is None:
        out = flash_attention_train(q, k, v, causal=True, window=window,
                                    q_block=cfg.attn_q_block,
                                    kv_block=cfg.attn_kv_block)
    elif x.shape[1] == 1:
        out = _decode(cfg, q, k, v, cache, cache_pos, window, split,
                      kv_whole)
    else:
        kq, vq = k, v
        if kv_whole:
            idx = torch.tensor(lay.kv_index(), device=x.device)
            kq, vq = k.index_select(2, idx), v.index_select(2, idx)
        out, _ = fa.flash_attention_fwd(q.contiguous(), kq.contiguous(),
                                        vq.contiguous(), True, window)
        Sc, S = (split.length if split else cache["k"].shape[1]), x.shape[1]
        if S >= Sc:
            k, v = k[:, S - Sc:], v[:, S - Sc:]
            if window and Sc:
                # keep the ring buffer's alignment: token t at slot t % Sc
                k = torch.roll(k, S % Sc, dims=1)
                v = torch.roll(v, S % Sc, dims=1)
        fill_block(cache["k"], k, split)
        fill_block(cache["v"], v, split)
    if cache is not None:
        cache = {"k": cache["k"], "v": cache["v"]}
    out = sctx.shard(out.to(cd), "batch", "seq", "heads", "head_dim")
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(cd))
    if lay is not None and lay.heads:
        y = tp.reduce_out(y)
    return sctx.shard(y, "batch", "seq", "embed"), cache

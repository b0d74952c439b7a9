"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434) (the port
of ``repro/models/mla.py``: ``mla_defs``, ``_q_proj``, ``_kv_compress``
and ``mla_block`` with and without a cache).

Queries and keys / values are low-rank compressed:
  c_q  = RMSNorm(x · W_dq)            (q_lora_rank)
  q    = c_q · W_uq  -> split [q_nope | q_pe];  q_pe gets RoPE
  c_kv | k_pe = x · W_dkv             (kv_lora_rank + rope_dim)
  c_kv = RMSNorm(c_kv);  k_pe gets RoPE (shared across heads)
  k    = [c_kv · W_uk | k_pe],  v = c_kv · W_uv

Training expands the latent into per-head keys and values and runs the
flash attention kernels with q and k at ``Dqk = qk_nope + qk_rope`` (192
at full width) and v at ``v_head_dim`` (128): the scale is ``1/√Dqk``, as
the reference takes it from q's last dim. ``k_pe`` is RoPE'd once at
``(B, S, 1, rope)`` and broadcast over the H heads into one contiguous
``(B, S, H, Dqk)`` key tensor.

Serving keeps only the compressed ``(ckv, kpe)`` cache, ``kv_lora +
rope`` values a token (576 at full width) instead of ``2·H·D``. The
prefill expands the latent as training does and runs the attention
forward kernel directly, outside autograd, at (Dqk, Dv) = (192, 128), then
writes ``c_kv[:, :Sc]`` / ``k_pe[:, :Sc]`` into the cache's first S slots
(the reference's fill, with its reach: S ≤ Sc). Decode is the absorbed
form::

    score_t = (q_nope · W_ukᵀ) · c_kv_t + q_pe · k_pe_t
    out     = (Σ p_t c_kv_t) · W_uv

so a step never expands the cache into per-head keys; its score and
context products keep the cache's dtype with an f32 result
(``attention.product_f32``). Both branches write the cache in place and
return it. ``sctx.shard`` stands at the reference's points (a no-op without a
mesh).

On a mesh whose ``model`` axis splits the heads (``models.tp``) the block
is a model-parallel region over them: ``w_uq``, ``w_uk``, ``w_uv`` and
``wo`` hold the rank's heads, the attention kernel runs at the local head
count, and ``wo``'s contraction over them leaves through ``reduce_out``.
The latents ``c_q``, ``c_kv`` and ``k_pe`` come from leaves that
``model`` does not split (``w_dq``, ``w_dkv`` and the norms), so they
enter the region through ``copy_in``, whose backward sums their partial
gradients over the ranks' heads. Serving on a mesh, the cache is the
rank's block of ``cache_specs``: ``ckv``'s latent rank over ``model``
(else its time dim), the time dims over ``data`` where the batch does
not split; the prefill writes the rank's block, and the absorbed decode
(``_absorbed_decode``) redistributes the decode-sized queries and
context and finishes a split time dim by flash-decoding.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.models.attention import (NEG_INF, apply_rope, fill_block,
                                          flash_attention_train,
                                          partial_softmax, product_f32,
                                          slot_positions, write_slot)
from repro_torch.models import sctx, tp
from repro_torch.models.common import ModelConfig, ParamDef, rms_norm


def mla_defs(cfg: ModelConfig) -> dict:
    a = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    qk = a.qk_nope_head_dim + a.qk_rope_head_dim
    return {
        "w_dq": ParamDef((d, a.q_lora_rank), ("embed", "lora")),
        "q_norm": ParamDef((a.q_lora_rank,), ("lora",), init="zeros"),
        "w_uq": ParamDef((a.q_lora_rank, H, qk),
                         ("lora", "q_heads", "head_dim")),
        "w_dkv": ParamDef((d, a.kv_lora_rank + a.qk_rope_head_dim),
                          ("embed", "lora")),
        "kv_norm": ParamDef((a.kv_lora_rank,), ("lora",), init="zeros"),
        "w_uk": ParamDef((a.kv_lora_rank, H, a.qk_nope_head_dim),
                         ("lora", "q_heads", "head_dim")),
        "w_uv": ParamDef((a.kv_lora_rank, H, a.v_head_dim),
                         ("lora", "q_heads", "head_dim")),
        "wo": ParamDef((H, a.v_head_dim, d), ("q_heads", "head_dim",
                                              "embed_out")),
    }


def _region() -> bool:
    lay = tp.current()
    return lay is not None and lay.heads


def _q_proj(cfg: ModelConfig, p, x, positions):
    a = cfg.mla
    cd = cfg.compute_dtype
    cq = rms_norm(torch.einsum("bsd,dr->bsr", x, p["w_dq"].to(cd)),
                  p["q_norm"])
    if _region():
        cq = tp.copy_in(cq)
    q = sctx.shard(torch.einsum("bsr,rhk->bshk", cq, p["w_uq"].to(cd)),
                   "batch", "seq", "heads", "head_dim")
    q_nope = q[..., :a.qk_nope_head_dim]
    q_pe = apply_rope(q[..., a.qk_nope_head_dim:], positions, cfg.rope_theta)
    return q_nope, q_pe


def _kv_compress(cfg: ModelConfig, p, x, positions):
    a = cfg.mla
    cd = cfg.compute_dtype
    ckv_full = torch.einsum("bsd,dr->bsr", x, p["w_dkv"].to(cd))
    c_kv = rms_norm(ckv_full[..., :a.kv_lora_rank], p["kv_norm"])
    k_pe = ckv_full[..., a.kv_lora_rank:][:, :, None, :]    # (B, S, 1, rope)
    k_pe = apply_rope(k_pe, positions, cfg.rope_theta)[:, :, 0]
    if _region():
        c_kv, k_pe = tp.copy_in(c_kv), tp.copy_in(k_pe)
    return c_kv, k_pe


def _splits(lay):
    """The time splits of the ``ckv`` and ``kpe`` caches (None: whole)."""
    if lay is None:
        return None, None
    return lay.time_split("ckv"), lay.time_split("kpe")


def _rank_block(c, ckv, lay):
    """The columns of the latent ``c`` (..., kv_lora_rank) that the cache
    block ``ckv`` holds: the rank's block where ``model`` splits the rank,
    else all of them."""
    n = ckv.shape[-1]
    if n == c.shape[-1]:
        return c
    return c.narrow(-1, lay.model_rank * n, n)


def _absorbed_decode(cfg: ModelConfig, p, q_nope, q_pe, c_kv, k_pe, cache,
                     cache_pos):
    """The absorbed decode step (B, 1, H_rank, v) f32, writing the new
    token's latents into the cache in place.

    On a mesh (``Layout.time`` and the cache's block) three cases meet:
    ``model`` splits the latent rank (the scores are partial sums over
    it: every head's on every rank, all-reduced over ``model``, the
    queries brought to the rank's rank block by an all-to-all and the
    context back to the rank's heads by another); ``model`` splits the
    ``ckv`` time dim while it splits the heads (every head's queries
    gathered, the rank's heads kept); and a time split of ``ckv`` / ``kpe``
    (over ``data``, and ``model`` where the rank does not divide), read by
    flash-decoding. ``kpe``'s time split is never finer than ``ckv``'s,
    so the rank reads the part of its ``kpe`` block under its ``ckv``
    block."""
    a = cfg.mla
    cd = cfg.compute_dtype
    lay = tp.current()
    ckv, kpe = cache["ckv"], cache["kpe"]
    split_c, split_k = _splits(lay)
    pos = cache_pos.to(torch.int64)
    write_slot(ckv, pos, _rank_block(c_kv[:, 0], ckv, lay), split_c)
    write_slot(kpe, pos, k_pe[:, 0], split_k)
    rank_split = ckv.shape[-1] != a.kv_lora_rank
    heads = lay is not None and lay.heads
    gather = heads and not rank_split and split_c is not None \
        and split_c.over_model
    # absorb W_uk into q: (B,1,H,nope) x (rank,H,nope) -> (B,H,rank)
    q_abs = torch.einsum("bshk,rhk->bhr", q_nope, p["w_uk"].to(cd))
    q_pe = q_pe[:, 0]                                        # (B, H, rope)
    hl = q_abs.shape[1]
    if rank_split and heads:
        q_abs = tp.all_to_all(q_abs, 2, 1, lay.model_group)  # (B,H,rank/m)
        q_pe = tp.gather_dim(q_pe, 1, lay.model_group)
    elif rank_split:
        q_abs = _rank_block(q_abs, ckv, lay)
    elif gather:
        q_abs = tp.gather_dim(q_abs, 1, lay.model_group)
        q_pe = tp.gather_dim(q_pe, 1, lay.model_group)
    n = ckv.shape[1]
    if split_c is not None:
        start = split_c.offset - (split_k.offset if split_k else 0)
        kpe = kpe[:, start:start + n]
    scale = 1.0 / math.sqrt(a.qk_nope_head_dim + a.qk_rope_head_dim)
    s = product_f32(q_abs.to(ckv.dtype), ckv.transpose(1, 2))
    if rank_split:
        s = tp.reduce_out(s)
    s = (s + product_f32(q_pe.to(kpe.dtype), kpe.transpose(1, 2))) * scale
    valid = slot_positions(n, split_c, s.device)[None, :] <= pos[:, None]
    s = torch.where(valid[:, None, :], s, NEG_INF)
    if split_c is None:
        prob = torch.softmax(s, dim=-1)
        ctx = product_f32(prob.to(ckv.dtype), ckv)           # (B, H, rank)
    else:
        m, l, e = partial_softmax(s, valid[:, None, :])
        ctx = tp.softmax_combine(m, l, product_f32(e.to(ckv.dtype), ckv),
                                 split_c)
    if rank_split and heads:
        ctx = tp.all_to_all(ctx, 1, 2, lay.model_group)     # (B, H/m, rank)
    elif rank_split:
        ctx = tp.gather_dim(ctx, 2, lay.model_group)
    elif gather:
        ctx = ctx.narrow(1, lay.model_rank * hl, hl)
    return torch.einsum("bhr,rhv->bhv", ctx.to(cd),
                        p["w_uv"].to(cd))[:, None]          # (B,1,H,v)


def mla_block(cfg: ModelConfig, p, x, positions, *, cache=None,
              cache_pos=None, **_unused):
    """One MLA block -> ``(y, cache)``, with ``attention_block``'s modes.
    cache: ``{ckv: (B, Sc, kv_lora_rank), kpe: (B, Sc, rope)}``."""
    a = cfg.mla
    cd = cfg.compute_dtype
    B, S, _ = x.shape
    H = p["w_uk"].shape[1]               # the rank's heads on a mesh
    q_nope, q_pe = _q_proj(cfg, p, x, positions)
    c_kv, k_pe = _kv_compress(cfg, p, x, positions)
    if cache is not None and S == 1:
        out = _absorbed_decode(cfg, p, q_nope, q_pe, c_kv, k_pe, cache,
                               cache_pos)
        cache = {"ckv": cache["ckv"], "kpe": cache["kpe"]}
    else:
        # ---- training / prefill: expand the latent, the attention kernel
        k_nope = sctx.shard(
            torch.einsum("bsr,rhk->bshk", c_kv, p["w_uk"].to(cd)),
            "batch", "seq", "heads", "head_dim")
        v = sctx.shard(torch.einsum("bsr,rhv->bshv", c_kv,
                                    p["w_uv"].to(cd)),
                       "batch", "seq", "heads", "head_dim")
        k = torch.cat([k_nope, k_pe[:, :, None, :].expand(
            B, S, H, a.qk_rope_head_dim)], dim=-1)
        q = torch.cat([q_nope, q_pe], dim=-1)
        if cache is None:
            out = flash_attention_train(q, k, v, causal=True,
                                        q_block=cfg.attn_q_block,
                                        kv_block=cfg.attn_kv_block)
        else:
            out, _ = fa.flash_attention_fwd(q.contiguous(), k.contiguous(),
                                            v.contiguous(), True, 0)
            lay = tp.current()
            ckv, kpe = cache["ckv"], cache["kpe"]
            split_c, split_k = _splits(lay)
            fill_block(ckv, _rank_block(c_kv, ckv, lay), split_c)
            fill_block(kpe, k_pe, split_k)
            cache = {"ckv": ckv, "kpe": kpe}
    out = sctx.shard(out.to(cd), "batch", "seq", "heads", "head_dim")
    y = torch.einsum("bshv,hvd->bsd", out, p["wo"].to(cd))
    if _region():
        y = tp.reduce_out(y)
    return sctx.shard(y, "batch", "seq", "embed"), cache

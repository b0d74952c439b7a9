"""Attention, the training path: RoPE, GQA, qk-norm, causal and sliding
window masks (the port of ``repro/models/attention.py``).

``flash_attention_train`` is the reference's custom-VJP flash attention:
``kernels.flash_attention.FlashAttention``, whose forward and backward
launch the CUDA kernels for tensors on the card and run the plain versions
(eager ports of ``_flash_fwd_impl`` / ``_flash_bwd_impl``) on the CPU.

Not ported yet (see ROADMAP.md): decode and prefill with a cache,
``decode_attention`` and ``blocked_attention``'s serving path.
``sctx.shard`` has no counterpart on one device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import (  # noqa: F401
    FlashAttention, _tile_mask)
from repro_torch.models.common import ModelConfig, ParamDef, rms_norm


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
    sec_id = torch.repeat_interleave(
        torch.arange(3, device=x.device),
        torch.tensor(list(sections), device=x.device))      # (half,)
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


def _project_qkv(cfg: ModelConfig, p, x, positions, *, theta,
                 mrope_positions=None):
    cd = cfg.compute_dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(cd))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(cd))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(cd))
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


def attention_block(cfg: ModelConfig, p, x, positions, *, kind="attn",
                    cache=None, cache_pos=None, mrope_positions=None):
    """One attention block, training / teacher-forced forward only
    (``cache is None``). Returns ``(y, None)`` like the reference."""
    if cache is not None:
        raise NotImplementedError(
            "attention with a cache (prefill / decode) is not ported to "
            "repro_torch yet; see ROADMAP.md, queue 1")
    cd = cfg.compute_dtype
    window = cfg.window if kind == "local" else 0
    theta = cfg.rope_theta if kind == "local" or not cfg.rope_theta_global \
        else cfg.rope_theta_global
    q, k, v = _project_qkv(cfg, p, x, positions, theta=theta,
                           mrope_positions=mrope_positions)
    out = flash_attention_train(q, k, v, causal=True, window=window,
                                q_block=cfg.attn_q_block,
                                kv_block=cfg.attn_kv_block)
    y = torch.einsum("bshk,hkd->bsd", out.to(cd), p["wo"].to(cd))
    return y, None

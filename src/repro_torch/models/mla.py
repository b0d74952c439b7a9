"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434), the
training path (the port of ``repro/models/mla.py``: ``mla_defs``,
``_q_proj``, ``_kv_compress`` and ``mla_block`` without a cache).

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

Not ported yet (see ROADMAP.md, queue 1): the compressed ``(ckv, kpe)``
cache and the absorbed decode. ``sctx.shard`` has no counterpart on one
device.
"""
from __future__ import annotations

import torch

from repro_torch.models.attention import apply_rope, flash_attention_train
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


def _q_proj(cfg: ModelConfig, p, x, positions):
    a = cfg.mla
    cd = cfg.compute_dtype
    cq = rms_norm(torch.einsum("bsd,dr->bsr", x, p["w_dq"].to(cd)),
                  p["q_norm"])
    q = torch.einsum("bsr,rhk->bshk", cq, p["w_uq"].to(cd))
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
    return c_kv, k_pe


def mla_block(cfg: ModelConfig, p, x, positions, *, cache=None,
              cache_pos=None, **_unused):
    """One MLA block, training / teacher-forced forward only (``cache is
    None``). Returns ``(y, None)`` like the reference."""
    if cache is not None:
        raise NotImplementedError(
            "MLA with a cache (the compressed (ckv, kpe) cache and the "
            "absorbed decode) is not ported to repro_torch yet; see "
            "ROADMAP.md, queue 1")
    a = cfg.mla
    cd = cfg.compute_dtype
    B, S, _ = x.shape
    H = cfg.n_heads
    q_nope, q_pe = _q_proj(cfg, p, x, positions)
    c_kv, k_pe = _kv_compress(cfg, p, x, positions)
    k_nope = torch.einsum("bsr,rhk->bshk", c_kv, p["w_uk"].to(cd))
    v = torch.einsum("bsr,rhv->bshv", c_kv, p["w_uv"].to(cd))
    k = torch.cat([k_nope, k_pe[:, :, None, :].expand(
        B, S, H, a.qk_rope_head_dim)], dim=-1)
    q = torch.cat([q_nope, q_pe], dim=-1)
    out = flash_attention_train(q, k, v, causal=True,
                                q_block=cfg.attn_q_block,
                                kv_block=cfg.attn_kv_block)
    y = torch.einsum("bshv,hvd->bsd", out.to(cd), p["wo"].to(cd))
    return y, None

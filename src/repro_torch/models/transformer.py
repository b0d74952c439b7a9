"""Decoder LM: every layer kind of the reference's pattern-cycled stack
(dense ``attn`` / ``local``, DeepSeek-V2's ``mla``, Mamba-2's ``ssm``,
Griffin's ``rglru``; with ``cfg.moe`` set every non-SSM layer's FFN is
the MoE FFN), its forward and its loss (the port of ``repro/models/
transformer.py``: ``model_defs``, ``forward`` without caches,
``_unembed_weight``, ``_divisor_chunk`` and ``lm_loss``).

Per pattern slot the layer params are stacked on a leading ``n_periods``
dim, as in the reference; the forward walks the periods in a Python loop
(the reference's ``lax.scan``). The loss head is the fused cross-entropy
(``kernels.fused_ce.FusedCrossEntropy``): the CUDA kernels on the card,
the dense plain version on the CPU.

Remat, as the reference does it: with ``cfg.remat`` other than ``"none"``
each period slot's layer runs under ``torch.utils.checkpoint`` (non-
reentrant) when autograd records, so the backward keeps one layer's
input per slot and recomputes the rest; ``"dots"`` is ``"full"`` (the
reference passes no policy). The remainder layers are not checkpointed,
nor is a forward under ``torch.no_grad()``. The recompute runs the layer's
forward kernels again, so a checkpointed layer launches its attention or
SSD forward twice per gradient.

Flat rows: ``ravel_layout`` / ``flatten_params`` / ``unflatten`` follow
``jax.flatten_util.ravel_pytree``'s order (dict keys sorted: ``blocks``,
``embed``, ``final_norm``, ``rem``; inside a block ``attn`` {k_norm,
q_norm, wk, wo, wq, wv}, ``ffn`` {w_down, w_gate, w_up}, ``norm1``,
``norm2``; an ``ssm`` block is {``norm1``, ``ssm`` {A_log, D, conv_b,
conv_w, dt_bias, norm, w_in, w_out}}, capitals first, as ``sorted`` and
``ravel_pytree`` order them; an ``rglru`` block is {``ffn``, ``norm1``,
``norm2``, ``rec`` {ba, bi, conv_b, conv_w, lam, w_out, w_x, w_y, wa,
wi}}; an ``mla`` block's ``attn`` is {kv_norm, q_norm, w_dkv, w_dq, w_uk,
w_uq, w_uv, wo}; with ``cfg.moe`` a block's ``moe`` {router, we_down,
we_gate, we_up, ws_down, ws_gate, ws_up} stands where ``ffn`` would,
before ``norm1``, ``norm2``), and ``params_from_jax`` carries the
reference's params across.

The aux loss: each MoE layer returns its load-balance loss, and
``forward`` sums them over the periods' slots and then the remainder
layers, the reference's order; without MoE it is 0.

Not ported yet (see ROADMAP.md): caches, ``prefill`` / ``decode_step``.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.fused_ce import FusedCrossEntropy
from repro_torch.models import attention
from repro_torch.models import ffn as ffn_lib
from repro_torch.models import mla as mla_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.common import (ModelConfig, ParamDef, rms_norm,
                                       tree_leaves_with_path, tree_map,
                                       tree_unflatten)
from repro_torch.utils.device import resolve_device

DENSE_KINDS = ("attn", "local")
PORTED_KINDS = DENSE_KINDS + ("mla", "ssm", "rglru")


# ---------------------------------------------------------------------------
# parameter definitions
# ---------------------------------------------------------------------------

def _block_defs(cfg: ModelConfig, kind: str) -> dict:
    if kind not in PORTED_KINDS:
        raise ValueError(f"unknown layer kind {kind}")
    d = cfg.d_model
    out = {"norm1": ParamDef((d,), ("embed",), init="zeros")}
    if kind in DENSE_KINDS:
        out["attn"] = attention.attention_defs(cfg)
    elif kind == "mla":
        out["attn"] = mla_lib.mla_defs(cfg)
    elif kind == "ssm":
        out["ssm"] = ssm_lib.ssm_defs(cfg)
        return out                          # mamba: no separate FFN
    else:
        out["rec"] = rglru_lib.rglru_defs(cfg)
    out["norm2"] = ParamDef((d,), ("embed",), init="zeros")
    if cfg.moe is not None:
        out["moe"] = moe_lib.moe_defs(cfg)
    else:
        out["ffn"] = ffn_lib.ffn_defs(cfg)
    return out


def _stack_defs(defs, n: int):
    return tree_map(lambda p: ParamDef((n,) + p.shape, ("layers",) + p.logical,
                                       p.init, p.scale), defs)


def model_defs(cfg: ModelConfig) -> dict:
    d, V = cfg.d_model, cfg.vocab_size
    defs = {
        "embed": ParamDef((V, d), ("vocab", "embed")),
        "final_norm": ParamDef((d,), ("embed",), init="zeros"),
        "blocks": tuple(_stack_defs(_block_defs(cfg, kind), cfg.n_periods)
                        for kind in cfg.pattern),
        "rem": tuple(_block_defs(cfg, kind) for kind in cfg.remainder_kinds),
    }
    if not cfg.tie_embeddings:
        defs["unembed"] = ParamDef((d, V), ("embed", "vocab"))
    return defs


# ---------------------------------------------------------------------------
# flat rows
# ---------------------------------------------------------------------------

def ravel_layout(cfg: ModelConfig) -> list:
    """``[(path, shape)]`` in flat-row order (``ravel_pytree``)."""
    return [(path, d.shape)
            for path, d in tree_leaves_with_path(model_defs(cfg))]


def n_params(cfg: ModelConfig) -> int:
    return sum(math.prod(s) for _, s in ravel_layout(cfg))


def flatten_params(params) -> torch.Tensor:
    """The flat f64 row in ``ravel_pytree`` order."""
    return torch.cat([leaf.reshape(-1).to(torch.float64)
                      for _, leaf in tree_leaves_with_path(params)])


def unflatten(row: torch.Tensor, cfg: ModelConfig):
    """Views of ``row`` as the parameter pytree (no copy). One ``split``:
    its backward writes the flat gradient in one concatenation, where a
    slice per leaf would each write a zero-filled gradient of the whole
    row (a 4 B-parameter row: 16 GB a leaf, beside the row and its
    gradient)."""
    layout = ravel_layout(cfg)
    sizes = [math.prod(s) for _, s in layout]
    if row.dim() != 1 or row.numel() != sum(sizes):
        raise ValueError(f"row has {row.numel()} elements, {cfg.name} needs "
                         f"{sum(sizes)}")
    views = {path: part.view(shape) for (path, shape), part in
             zip(layout, torch.split(row, sizes))}
    return _assemble(model_defs(cfg), views)


def _assemble(defs, views, path=()):
    if isinstance(defs, dict):
        return {k: _assemble(v, views, path + (k,)) for k, v in defs.items()}
    if isinstance(defs, tuple):
        return tuple(_assemble(v, views, path + (i,))
                     for i, v in enumerate(defs))
    return views[path]


def params_from_jax(params_or_flat_row, cfg: ModelConfig, device=None):
    """Carry the reference's params across: ``params_or_flat_row`` is the
    reference's param pytree (nested dicts / tuples of arrays) or its flat
    ``ravel_pytree`` row. Returns ``(params, row)``: the pytree as f32
    tensors in the same layout, and the flat f64 row."""
    dev = resolve_device(device)
    layout = ravel_layout(cfg)
    if isinstance(params_or_flat_row, dict):
        leaves = tree_leaves_with_path(params_or_flat_row)
        if [p for p, _ in leaves] != [p for p, _ in layout]:
            raise ValueError(f"param paths do not match {cfg.name}'s layout")
        parts = []
        for (path, leaf), (_, shape) in zip(leaves, layout):
            a = np.asarray(leaf)
            if a.shape != tuple(shape):
                raise ValueError(f"{path}: shape {a.shape} != {shape}")
            parts.append(np.asarray(a, np.float64).reshape(-1))
        flat = np.concatenate(parts)
    else:
        flat = np.asarray(params_or_flat_row, np.float64)
    row = torch.from_numpy(np.array(flat, dtype=np.float64)).to(dev)
    params = tree_map(lambda t: t.to(torch.float32).clone(),
                      unflatten(row, cfg))
    return params, row


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _apply_block(cfg: ModelConfig, kind: str, p, x, positions,
                 mrope_positions=None):
    """One layer: ``(x, aux)``, aux the MoE FFN's load-balance loss (0
    without one)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rms_norm(x, p["norm1"])
    if kind == "ssm":
        y, _ = ssm_lib.ssm_block(cfg, p["ssm"], h, positions)
        return x + y, aux
    if kind == "rglru":
        y, _ = rglru_lib.rglru_block(cfg, p["rec"], h, positions)
    elif kind == "mla":
        y, _ = mla_lib.mla_block(cfg, p["attn"], h, positions)
    else:
        y, _ = attention.attention_block(cfg, p["attn"], h, positions,
                                         kind=kind,
                                         mrope_positions=mrope_positions)
    x = x + y
    h2 = rms_norm(x, p["norm2"])
    if cfg.moe is not None:
        y2, aux = moe_lib.moe_block(cfg, p["moe"], h2)
    else:
        y2 = ffn_lib.ffn_block(cfg, p["ffn"], h2)
    return x + y2, aux


def _unstack(tree, n: int) -> list:
    """The n layers of a stacked param pytree, as n lists of views in tree
    order: one ``unbind`` per leaf, whose backward stacks the n layers'
    gradients in one pass. Indexing ``t[i]`` per layer instead costs a
    zero-filled full-size gradient per layer and leaf, n² layer-sized
    writes."""
    leaves = [t.unbind(0) for _, t in tree_leaves_with_path(tree)]
    return [[ts[i] for ts in leaves] for i in range(n)]


def _slot_fn(cfg: ModelConfig, kind: str, structure):
    """One period slot's layer as a function of tensors alone: the hidden
    state, the positions and the layer's parameter views (``_unstack``'s
    list) as arguments, so a checkpoint sees them as its inputs. Returns
    ``(h, aux)``."""
    def fn(x, positions, mrope_positions, *leaves):
        p = tree_unflatten(structure, list(leaves))
        return _apply_block(cfg, kind, p, x, positions, mrope_positions)
    return fn


def forward(cfg: ModelConfig, params, tokens, *, positions=None,
            mrope_positions=None, patch_embeds=None):
    """tokens: (B, S) int64. Returns ``(hidden (B, S, d), None, aux)`` like
    the reference's training forward (no caches; aux the MoE layers'
    load-balance losses summed in the reference's order, 0 without MoE).
    ``patch_embeds`` (B, P, d) replace the embeddings of the first P
    positions (the vision stub); ``mrope_positions`` (3, B, S) drive
    M-RoPE where the config has ``mrope_sections``."""
    cd = cfg.compute_dtype
    B, S = tokens.shape
    h = params["embed"][tokens].to(cd)
    if patch_embeds is not None:
        P_ = patch_embeds.shape[1]
        h = torch.cat([patch_embeds.to(cd), h[:, P_:]], dim=1)
    if positions is None:
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    layers = [_unstack(params["blocks"][s], cfg.n_periods)
              for s in range(len(cfg.pattern))]
    remat = cfg.remat != "none" and torch.is_grad_enabled()
    slots = [_slot_fn(cfg, kind, params["blocks"][s])
             for s, kind in enumerate(cfg.pattern)]
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(cfg.n_periods):
        for s in range(len(cfg.pattern)):
            if remat:
                h, a = checkpoint(slots[s], h, positions, mrope_positions,
                                  *layers[s][i], use_reentrant=False)
            else:
                h, a = slots[s](h, positions, mrope_positions,
                                *layers[s][i])
            aux = aux + a
    for i, kind in enumerate(cfg.remainder_kinds):
        h, a = _apply_block(cfg, kind, params["rem"][i], h, positions,
                            mrope_positions)
        aux = aux + a
    h = rms_norm(h, params["final_norm"])
    return h, None, aux


# ---------------------------------------------------------------------------
# LM head / loss
# ---------------------------------------------------------------------------

def _unembed_weight(cfg: ModelConfig, params):
    if cfg.tie_embeddings:
        return params["embed"].T                      # (d, V)
    return params["unembed"]


def _divisor_chunk(T: int, want: int) -> int:
    c = min(want, T)
    while T % c:
        c -= 1
    return max(c, 1)


def lm_loss(cfg: ModelConfig, params, batch):
    """Next-token cross-entropy. batch: {tokens (B,S), targets (B,S),
    mask (B,S)} + the modality extras ``mrope_positions`` and
    ``patch_embeds``, passed on to ``forward``. Returns ``(loss, {ce, aux,
    accuracy, tokens})`` like the reference. The reference chunks the
    sequence to bound its logits memory; the fused kernels never hold the
    logits, so the port runs the whole batch through one call (only the
    order of the final sums differs)."""
    if cfg.logit_softcap:
        raise NotImplementedError(
            "logit_softcap is not supported by the fused cross-entropy; see "
            "ROADMAP.md")
    extra = {k: batch[k] for k in ("mrope_positions", "patch_embeds")
             if k in batch}
    h, _, aux = forward(cfg, params, batch["tokens"], **extra)
    B, S, d = h.shape
    w = _unembed_weight(cfg, params).to(h.dtype)
    mask = batch["mask"].to(torch.float32).reshape(-1)
    targets = batch["targets"].reshape(-1).to(torch.int64)
    loss_t, pred = FusedCrossEntropy.apply(h.reshape(B * S, d), w, targets)
    n_tok = mask.sum()
    denom = torch.clamp_min(n_tok, 1.0)
    ce = (loss_t * mask).sum() / denom
    correct = ((pred == targets).to(torch.float32) * mask).sum()
    loss = ce + aux
    return loss, {"ce": ce, "aux": aux, "accuracy": correct / denom,
                  "tokens": n_tok}

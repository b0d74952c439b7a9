"""Decoder LM: every layer kind of the reference's pattern-cycled stack
(dense ``attn`` / ``local``, DeepSeek-V2's ``mla``, Mamba-2's ``ssm``,
Griffin's ``rglru``; with ``cfg.moe`` set every non-SSM layer's FFN is
the MoE FFN), its forward and its loss (the port of ``repro/models/
transformer.py``: ``model_defs``, the caches, ``forward``,
``_unembed_weight``, ``logits_at``, ``_divisor_chunk``, ``lm_loss``,
``prefill`` and ``decode_step``).

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

Serving. A cache tree has the reference's layout and dtypes:
``{"stacked": per-slot dicts with a leading n_periods dim, "rem": one dict
per remainder layer}``; attention ``k`` / ``v`` (a ``local`` layer's
ring buffer holds ``min(window, max_len)`` slots), MLA's compressed
``ckv`` / ``kpe``, the SSM and RG-LRU ``conv`` history in the compute
dtype and their ``state`` in f32. ``forward`` with caches walks the
periods and slots as the reference's ``scan`` does, handing each layer
its views of the stacked caches; every layer writes its cache in place
(the reference donates its caches), so ``prefill`` and ``decode_step``
return the tree they were given, filled. Decode positions come from
``cache_pos`` when S is 1. Serving runs with autograd off
(``torch.inference_mode()`` in ``runtime.serve``), where no layer is
checkpointed and the prefill's attention and SSD forward kernels are
called directly. On a mesh ``runtime.serve`` hands ``prefill`` and
``decode_step`` the rank's blocks of the caches (``init_cache_defs``'
shapes cut by ``cache_specs``), and each layer reads how its cache is
split, its time dim's for flash-decoding included, from the installed
``tp.Layout``, each kind's (global and ``local`` layers apart).

``cast_for_serving`` makes, once, each leaf in the dtype the reference
casts it to at its every use (``p["wq"].astype(cd)``): the blocks'
weights and the embedding (for the lookup) in the compute dtype, the
norms, gates, SSM scalars and router in f32, and the unembedding (the
tied ``embed.T`` too) in f32 for ``logits_at``. A cast is deterministic,
so this is bit for bit the per-use cast; eager torch would otherwise
copy every weight on every decode step, and the f32 master leaves can be
freed. ``caches_from_jax`` / ``caches_to_numpy`` carry cache trees across
from and to the reference's layout.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.fused_ce import (FusedCrossEntropy,
                                          vocab_parallel_cross_entropy)
from repro_torch.models import attention
from repro_torch.models import ffn as ffn_lib
from repro_torch.models import mla as mla_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import sctx, tp
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.common import (ModelConfig, ParamDef, ShapeDtype,
                                       rms_norm, softcap,
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
# caches
# ---------------------------------------------------------------------------

def _cache_def_one(cfg: ModelConfig, kind: str, B: int, max_len: int):
    cd = cfg.compute_dtype
    D = cfg.resolved_head_dim
    if kind in DENSE_KINDS:
        S = max_len if kind == "attn" else min(cfg.window, max_len)
        kv = ShapeDtype((B, S, cfg.n_kv_heads, D), cd)
        return {"k": kv, "v": kv}
    if kind == "mla":
        a = cfg.mla
        return {"ckv": ShapeDtype((B, max_len, a.kv_lora_rank), cd),
                "kpe": ShapeDtype((B, max_len, a.qk_rope_head_dim), cd)}
    if kind == "ssm":
        s = cfg.ssm
        d_inner, H, conv_dim = ssm_lib._dims(cfg)
        return {"conv": ShapeDtype((B, s.d_conv - 1, conv_dim), cd),
                "state": ShapeDtype((B, H, s.head_dim, s.d_state),
                                    torch.float32)}
    if kind == "rglru":
        g = cfg.rglru
        return {"conv": ShapeDtype((B, g.d_conv - 1, g.width), cd),
                "state": ShapeDtype((B, g.width), torch.float32)}
    raise ValueError(f"unknown layer kind {kind}")


def init_cache_defs(cfg: ModelConfig, B: int, max_len: int):
    """The cache tree as ``ShapeDtype`` records: ``{"stacked": one dict per
    pattern slot with a leading n_periods dim, "rem": one per remainder
    layer}``."""
    def stack(tree):
        return tree_map(lambda d: ShapeDtype((cfg.n_periods,) + d.shape,
                                             d.dtype), tree)
    return {"stacked": tuple(stack(_cache_def_one(cfg, kind, B, max_len))
                             for kind in cfg.pattern),
            "rem": tuple(_cache_def_one(cfg, kind, B, max_len)
                         for kind in cfg.remainder_kinds)}


def init_caches(cfg: ModelConfig, B: int, max_len: int, device=None):
    """Zero caches on ``device`` (None: the card)."""
    dev = resolve_device(device)
    return tree_map(lambda d: torch.zeros(d.shape, dtype=d.dtype,
                                          device=dev),
                    init_cache_defs(cfg, B, max_len))


def caches_from_jax(caches, cfg: ModelConfig, device=None):
    """The reference's cache tree (arrays in its layout) as the port's, in
    the port's cache dtypes: ``state`` f32, the rest the compute dtype (a
    bf16 array passes through f32 exactly)."""
    dev = resolve_device(device)

    def layer(c):
        return {k: torch.from_numpy(np.array(a, np.float32)).to(
            device=dev, dtype=torch.float32 if k == "state"
            else cfg.compute_dtype) for k, a in c.items()}
    return {"stacked": tuple(layer(c) for c in caches["stacked"]),
            "rem": tuple(layer(c) for c in caches["rem"])}


def caches_to_numpy(caches):
    """A cache tree as f32 numpy arrays, in the same layout."""
    return tree_map(lambda t: t.detach().to("cpu", torch.float32).numpy(),
                    caches)


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


def unflatten(row: torch.Tensor, cfg: ModelConfig, layout=None):
    """Views of ``row`` as the parameter pytree (no copy). One ``split``:
    its backward writes the flat gradient in one concatenation, where a
    slice per leaf would each write a zero-filled gradient of the whole
    row (a 4 B-parameter row: 16 GB a leaf, beside the row and its
    gradient). ``layout`` (``[(path, shape)]`` in row order) gives a
    rank's local shapes on a mesh (``runtime.sharding.local_layout``)."""
    layout = layout or ravel_layout(cfg)
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
                 mrope_positions=None, cache=None, cache_pos=None):
    """One layer: ``(x, aux, cache)``, aux the MoE FFN's load-balance loss
    (0 without one; on a mesh this rank's share), cache the layer's cache
    written in place (None without one)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rms_norm(x, p["norm1"])
    kw = {"cache": cache, "cache_pos": cache_pos}
    if kind == "ssm":
        y, cache = ssm_lib.ssm_block(cfg, p["ssm"], h, positions, **kw)
        return x + y, aux, cache
    if kind == "rglru":
        y, cache = rglru_lib.rglru_block(cfg, p["rec"], h, positions, **kw)
    elif kind == "mla":
        y, cache = mla_lib.mla_block(cfg, p["attn"], h, positions, **kw)
    else:
        y, cache = attention.attention_block(
            cfg, p["attn"], h, positions, kind=kind,
            mrope_positions=mrope_positions, **kw)
    x = x + y
    h2 = rms_norm(x, p["norm2"])
    if cfg.moe is not None:
        y2, aux = moe_lib.moe_block(cfg, p["moe"], h2)
    else:
        y2 = ffn_lib.ffn_block(cfg, p["ffn"], h2)
    return x + y2, aux, cache


def _unstack(tree, n: int) -> list:
    """The n layers of a stacked param pytree, as n lists of views in tree
    order: one ``unbind`` per leaf, whose backward stacks the n layers'
    gradients in one pass. Indexing ``t[i]`` per layer instead costs a
    zero-filled full-size gradient per layer and leaf, n² layer-sized
    writes."""
    leaves = [t.unbind(0) for _, t in tree_leaves_with_path(tree)]
    return [[ts[i] for ts in leaves] for i in range(n)]


def _slot_fn(cfg: ModelConfig, kind: str, structure, constrain=None):
    """One period slot's layer as a function of tensors alone: the hidden
    state, the positions and the layer's parameter views (``_unstack``'s
    list) as arguments, so a checkpoint sees them as its inputs (and a
    ``constrain`` gather inside it runs again in the recompute, as the
    reference's inside ``jax.checkpoint``). Returns ``(h, aux)``. The
    mesh layout installed now is installed again around each call: a
    checkpoint's recompute runs in the backward, on the card in the
    autograd engine's own thread, where the forward's context variables
    are not set."""
    layout = tp.current()

    def fn(x, positions, mrope_positions, *leaves):
        with tp.use(layout):
            p = tree_unflatten(structure, list(leaves))
            if constrain is not None:
                p = constrain(kind, p)
            x, aux, _ = _apply_block(cfg, kind, p, x, positions,
                                     mrope_positions)
            return sctx.shard(x, "batch", "seq", "embed"), aux
    return fn


def _embed(cfg: ModelConfig, table, tokens):
    """The embedding lookup in the compute dtype. On a mesh whose
    ``model`` axis splits the vocabulary, each rank looks up the tokens its
    rows hold (zeros for the rest) and the partial rows are summed over
    ``model`` (one rank contributes each row, so the sum is exact)."""
    lay = tp.current()
    if lay is None or not lay.vocab:
        return table[tokens].to(cfg.compute_dtype)
    local = tokens - lay.vocab_start
    held = (local >= 0) & (local < table.shape[0])
    rows = table[torch.where(held, local, 0)]
    rows = torch.where(held[..., None], rows, 0).to(cfg.compute_dtype)
    return tp.reduce_out(rows)


def forward(cfg: ModelConfig, params, tokens, *, positions=None,
            caches=None, cache_pos=None, mrope_positions=None,
            patch_embeds=None, constrain=None):
    """tokens: (B, S) int64. Returns ``(hidden (B, S, d), caches, aux)``
    like the reference: aux the MoE layers' load-balance losses summed in
    the reference's order (0 without MoE); with ``caches`` (a prefill, or
    with S 1 and ``cache_pos`` (B,) a decode step) the tree written in
    place, else None. ``patch_embeds`` (B, P, d) replace the embeddings of
    the first P positions (the vision stub); ``mrope_positions`` (3, B, S)
    drive M-RoPE where the config has ``mrope_sections``.
    ``constrain(kind, params_subtree)`` (optional) re-lays one layer's
    params out before use: on a mesh, ``runtime.sharding.
    block_constrainer``'s streaming-FSDP gather (for ``final_norm`` too)."""
    cd = cfg.compute_dtype
    B, S = tokens.shape
    h = sctx.shard(_embed(cfg, params["embed"], tokens),
                   "batch", "seq", "embed")
    if patch_embeds is not None:
        P_ = patch_embeds.shape[1]
        h = torch.cat([patch_embeds.to(cd), h[:, P_:]], dim=1)
    if positions is None:
        if cache_pos is not None and S == 1:
            positions = cache_pos[:, None]
        else:
            positions = torch.arange(S, device=tokens.device)[None].expand(
                B, S)
    layers = [_unstack(params["blocks"][s], cfg.n_periods)
              for s in range(len(cfg.pattern))]
    remat = cfg.remat != "none" and torch.is_grad_enabled() \
        and caches is None
    slots = [_slot_fn(cfg, kind, params["blocks"][s], constrain)
             for s, kind in enumerate(cfg.pattern)]
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(cfg.n_periods):
        for s, kind in enumerate(cfg.pattern):
            if caches is not None:
                p = tree_unflatten(params["blocks"][s], layers[s][i])
                if constrain is not None:
                    p = constrain(kind, p)
                c = {k: t[i] for k, t in caches["stacked"][s].items()}
                h, a, _ = _apply_block(cfg, kind, p, h, positions,
                                       mrope_positions, c, cache_pos)
                h = sctx.shard(h, "batch", "seq", "embed")
            elif remat:
                h, a = checkpoint(slots[s], h, positions, mrope_positions,
                                  *layers[s][i], use_reentrant=False)
            else:
                h, a = slots[s](h, positions, mrope_positions,
                                *layers[s][i])
            aux = aux + a
    for i, kind in enumerate(cfg.remainder_kinds):
        c = caches["rem"][i] if caches is not None else None
        p = params["rem"][i]
        if constrain is not None:
            p = constrain(kind, p)
        h, a, _ = _apply_block(cfg, kind, p, h, positions, mrope_positions,
                               c, cache_pos)
        aux = aux + a
    final_norm = params["final_norm"]
    if constrain is not None:
        final_norm = constrain("final_norm", final_norm)
    h = rms_norm(h, final_norm)
    return h, caches, aux


# ---------------------------------------------------------------------------
# LM head / loss
# ---------------------------------------------------------------------------

def _unembed_weight(cfg: ModelConfig, params):
    """(d, V): ``unembed``, or for a tied config ``embed.T``; a tree from
    ``cast_for_serving`` carries it under ``unembed`` either way."""
    if cfg.tie_embeddings and "unembed" not in params:
        return params["embed"].T
    return params["unembed"]


def logits_at(cfg: ModelConfig, params, h):
    """f32 logits of the given hidden states (a few positions only),
    soft-capped by ``cfg.logit_softcap``."""
    w = _unembed_weight(cfg, params)
    out = torch.matmul(h.to(torch.float32), w.to(torch.float32))
    return softcap(out, cfg.logit_softcap)


def _divisor_chunk(T: int, want: int) -> int:
    c = min(want, T)
    while T % c:
        c -= 1
    return max(c, 1)


def lm_loss(cfg: ModelConfig, params, batch, extra_fwd_kwargs=None):
    """Next-token cross-entropy. batch: {tokens (B,S), targets (B,S),
    mask (B,S)} + the modality extras ``mrope_positions`` and
    ``patch_embeds``, passed on to ``forward`` with ``extra_fwd_kwargs``
    (the runtime's ``constrain``). Returns ``(loss, {ce, aux, accuracy,
    tokens})`` like the reference. The reference chunks the sequence to
    bound its logits memory; the fused kernels never hold the logits, so
    the port runs the whole batch through one call (only the order of the
    final sums differs).

    On a mesh (``models.tp``) the batch holds this rank's rows of the
    pod's batch: ``tokens`` is the pod's count (summed over ``data``), and
    the loss, ``ce``, ``aux`` (each MoE layer's share, ``models.moe``) and
    ``accuracy`` are this rank's shares of the pod's, which sum over
    ``data`` to them (the gradient's sum over ``data`` is the pod's).
    Where ``model`` splits the vocabulary the loss head runs
    vocab-parallel (``kernels.fused_ce.vocab_parallel_cross_entropy``)."""
    if cfg.logit_softcap:
        raise NotImplementedError(
            "logit_softcap is not supported by the fused cross-entropy; see "
            "ROADMAP.md")
    extra = dict(extra_fwd_kwargs or {})
    extra.update({k: batch[k] for k in ("mrope_positions", "patch_embeds")
                  if k in batch})
    h, _, aux = forward(cfg, params, batch["tokens"], **extra)
    B, S, d = h.shape
    w = _unembed_weight(cfg, params).to(h.dtype)
    mask = batch["mask"].to(torch.float32).reshape(-1)
    targets = batch["targets"].reshape(-1).to(torch.int64)
    lay = tp.current()
    if lay is not None and lay.vocab:
        loss_t, pred = vocab_parallel_cross_entropy(
            tp.copy_in(h.reshape(B * S, d)), w, targets, lay.vocab_start,
            lay.model_group)
    else:
        loss_t, pred = FusedCrossEntropy.apply(h.reshape(B * S, d), w,
                                               targets)
    n_tok = tp.data_sum(mask.sum())
    denom = torch.clamp_min(n_tok, 1.0)
    ce = (loss_t * mask).sum() / denom
    correct = ((pred == targets).to(torch.float32) * mask).sum()
    loss = ce + aux
    return loss, {"ce": ce, "aux": aux, "accuracy": correct / denom,
                  "tokens": n_tok}


# ---------------------------------------------------------------------------
# serving entry points
# ---------------------------------------------------------------------------

# the leaves the reference reads in f32 (norm scales, the RG-LRU gates, the
# SSM's scalars, the MoE router); every other block leaf it casts to the
# compute dtype at each use
F32_LEAVES = frozenset({"norm1", "norm2", "final_norm", "q_norm", "k_norm",
                        "kv_norm", "norm", "A_log", "D", "dt_bias", "wa",
                        "ba", "wi", "bi", "lam", "router"})


def cast_for_serving(cfg: ModelConfig, params):
    """The params as serving reads them, each leaf cast once to the dtype
    the reference casts it to at every use (module docstring): the
    ``embed`` lookup table in the compute dtype and ``unembed`` ((d, V),
    for a tied config ``embed.T``) in f32. Leaves already in their dtype
    are shared, not copied."""
    cd = cfg.compute_dtype
    rest = {k: v for k, v in params.items() if k not in ("embed", "unembed")}
    out = tree_unflatten(rest, [
        t.to(torch.float32 if path[-1] in F32_LEAVES else cd)
        for path, t in tree_leaves_with_path(rest)])
    out["embed"] = params["embed"].to(cd)
    out["unembed"] = _unembed_weight(cfg, params).to(torch.float32)
    return out


def prefill(cfg: ModelConfig, params, tokens, caches, *,
            mrope_positions=None, patch_embeds=None, constrain=None):
    """A teacher-forced pass that fills ``caches`` (in place); returns the
    last position's logits (B, V) f32 and the caches."""
    h, caches, _ = forward(cfg, params, tokens, caches=caches,
                           mrope_positions=mrope_positions,
                           patch_embeds=patch_embeds, constrain=constrain)
    return logits_at(cfg, params, h[:, -1]), caches


def decode_step(cfg: ModelConfig, params, token, caches, cache_pos, *,
                mrope_positions=None, constrain=None):
    """token: (B, 1); cache_pos: (B,) each row's position. Returns the next
    token's logits (B, V) f32 and the caches, written in place."""
    h, caches, _ = forward(cfg, params, token, caches=caches,
                           cache_pos=cache_pos,
                           mrope_positions=mrope_positions,
                           constrain=constrain)
    return logits_at(cfg, params, h[:, -1]), caches

"""Serving: the prefill and decode steps, and a small continuous-batching
engine (the port of ``repro/runtime/serve.py``), on one device.

``build_serve_steps`` returns the reference's two callables with its
argument order, ``prefill(params, tokens, extras)`` and ``decode(params,
caches, token, pos, extras)``, each run under ``torch.inference_mode()``:
no autograd, so the prefill's attention and SSD forward kernels are called
directly and save nothing. ``params`` is the tree ``cast_params`` makes
once from the f32 masters (``transformer.cast_for_serving``: each leaf in
the dtype the reference casts it to at every use); the steps also take the
masters, which then cast per use. The prefill starts from zero caches of
``(batch, max_len)`` on the build's device. The decode writes the caches
it is given in place and returns them, as the reference donates them
(``donate_argnums=(1,)``): no caller may use a cache tree it has passed
on.

With a ``mesh`` (``launch.mesh``) the steps run on every rank of it and
the sharding fields are filled: ``cast_params`` keeps this rank's shards
of the params (``param_specs``), each rank takes its rows of the tokens
(``token_spec``: the batch over ``data`` where B is a multiple of it, else
every rank holds every row), the model runs on local shards
(``models.tp``) and the logits come back whole on every rank, gathered
over ``model`` (vocab) and ``data`` (batch). Every layer kind serves. The
caches are the rank's blocks of ``cache_specs``: the batch over ``data``;
attention's kv heads, MLA's latent rank, the SSM's conv columns and heads
and the RG-LRU width over ``model``; and where those do not divide, the
time dim of the attention and MLA caches over ``data`` and / or
``model``. A cache split along time is read by flash-decoding: each rank
attends over its block and ``tp.softmax_combine`` finishes the partial
softmax terms over the axes that split it (``sharding.time_splits``
gives each rank its block, ``Layout.time`` carries it to the layers).
On one device the sharding fields are None.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models import tp
from repro_torch.models import transformer as tfm
from repro_torch.models.common import (ModelConfig, ShapeDtype,
                                       abstract_params, spec_leaves,
                                       tree_leaves_with_path, tree_unflatten)
from repro_torch.runtime import sharding as shd
from repro_torch.utils.device import fp32_products, resolve_device


@dataclasses.dataclass(frozen=True)
class ServeBuild:
    prefill: Any              # (params, tokens, extras) -> (logits, caches)
    decode: Any               # (params, caches, token, pos, extras) -> same
    abstract_params: Any      # ShapeDtype records of the f32 masters
    abstract_caches: Any      # ShapeDtype records of the caches
    cast_params: Any          # f32 master params -> the steps' leaves
    param_specs: Any = None   # the sharding fields: no mesh on one device
    cache_spec_tree: Any = None
    token_spec: Any = None


def _extra_kwargs(cfg: ModelConfig, B: int, S: int) -> dict:
    """The modality extras a step of S tokens takes, as ShapeDtype
    records: M-RoPE positions (3, B, S) and, where the prompt is longer
    than the patches, the patch embeddings (B, P, d)."""
    extras = {}
    if cfg.mrope_sections is not None:
        extras["mrope_positions"] = ShapeDtype((3, B, S), torch.int32)
    if cfg.patch_embed_tokens and S > cfg.patch_embed_tokens:
        extras["patch_embeds"] = ShapeDtype(
            (B, cfg.patch_embed_tokens, cfg.d_model), cfg.compute_dtype)
    return extras


def build_serve_steps(cfg: ModelConfig, *, batch: int, max_len: int,
                      device=None, mesh=None) -> ServeBuild:
    """The prefill and decode steps for ``batch`` rows of at most
    ``max_len`` positions on ``device`` (None: the card), placed on
    ``mesh`` when one is given (module docstring)."""
    dev = resolve_device(device)
    fp32_products()
    layout = constrain = None
    rows = slice(0, batch)
    specs = {}
    cache_defs = tfm.init_cache_defs(cfg, batch, max_len)
    if mesh is not None:
        sizes = shd.mesh_axis_sizes(mesh)
        pspecs = shd.param_specs(cfg, mesh)
        cspecs = shd.cache_specs(cfg, mesh, batch, max_len)
        tspec = shd.serve_token_specs(cfg, mesh, batch)
        specs = dict(param_specs=pspecs, cache_spec_tree=cspecs,
                     token_spec=tspec)
        layout = tp.layout_for(cfg, mesh)
        if layout is not None:
            constrain = shd.block_constrainer(cfg, mesh)
            layout = dataclasses.replace(
                layout, data_rows=tspec[0] == "data",
                time=tuple((name, tp.TimeSplit(
                    axes, tuple(mesh.get_group(a) for a in axes), *where))
                    for name, (axes, *where) in shd.time_splits(
                        cfg, mesh, batch, max_len).items()))
        if tspec[0] == "data":
            n = batch // sizes["data"]
            rows = slice(mesh.get_local_rank("data") * n,
                         (mesh.get_local_rank("data") + 1) * n)
        cache_defs = tree_unflatten(cache_defs, [
            ShapeDtype(shd.local_shape(d.shape, s, sizes), d.dtype)
            for (_, d), s in zip(tree_leaves_with_path(cache_defs),
                                 spec_leaves(cspecs))])

    def local(extras: dict) -> dict:
        # mrope_positions (3, B, S) carries the batch at dim 1
        return {k: (v[:, rows] if k == "mrope_positions" else v[rows])
                for k, v in extras.items()}

    def gathered(logits):
        if layout is not None and layout.vocab:
            logits = tp.gather_dim(logits, 1, layout.model_group)
        if rows.stop - rows.start < batch:
            logits = tp.gather_dim(logits, 0, layout.data_group)
        return logits

    def prefill_fn(params, tokens, extras):
        with torch.inference_mode(), tp.use(layout):
            caches = tree_unflatten(cache_defs, [
                torch.zeros(d.shape, dtype=d.dtype, device=dev)
                for _, d in tree_leaves_with_path(cache_defs)])
            logits, caches = tfm.prefill(cfg, params, tokens[rows], caches,
                                         constrain=constrain, **local(extras))
            return gathered(logits), caches

    def decode_fn(params, caches, token, pos, extras):
        with torch.inference_mode(), tp.use(layout):
            logits, caches = tfm.decode_step(cfg, params, token[rows],
                                             caches, pos[rows],
                                             constrain=constrain,
                                             **local(extras))
            return gathered(logits), caches

    def cast_params(params):
        with torch.inference_mode():
            if mesh is not None:
                params = tree_unflatten(params, [
                    shd.local_shard(t, mesh, s) for (_, t), s in
                    zip(tree_leaves_with_path(params),
                        spec_leaves(specs["param_specs"]))])
            return tfm.cast_for_serving(cfg, params)

    return ServeBuild(
        prefill=prefill_fn,
        decode=decode_fn,
        abstract_params=abstract_params(tfm.model_defs(cfg),
                                        cfg.param_dtype),
        abstract_caches=tfm.init_cache_defs(cfg, batch, max_len),
        cast_params=cast_params,
        **specs,
    )


# ---------------------------------------------------------------------------
# minimal continuous-batching engine (examples/serve_torch.py)
# ---------------------------------------------------------------------------

class BatchingEngine:
    """Greedy decode over a fixed batch of request slots.

    Requests join free slots; each step decodes one token for every slot
    and appends it to the active ones; a request that has ``stop_len``
    tokens or reaches ``max_len − 1`` frees its slot. A request joins by
    decoding its prompt token by token over the whole batch, which fills
    its slot's cache without disturbing the others (theirs are written
    again with what they hold). Greedy means the first index of the
    largest logit, as ``jnp.argmax`` takes it. The engine holds the
    params cast once (``transformer.cast_for_serving``) and its caches on
    ``device`` (None: the card).
    """

    def __init__(self, cfg: ModelConfig, params, batch: int, max_len: int,
                 device=None):
        dev = self.device = resolve_device(device)
        fp32_products()
        self.cfg = cfg
        self.batch = batch
        self.max_len = max_len
        with torch.inference_mode():
            self.params = tfm.cast_for_serving(cfg, params)
            self.caches = tfm.init_caches(cfg, batch, max_len, device=dev)
        self.pos = torch.zeros((batch,), dtype=torch.int64, device=dev)
        self.cur = torch.zeros((batch, 1), dtype=torch.int64, device=dev)
        self.active = [False] * batch
        self.outputs: dict[int, list] = {}
        self._slot_of: dict[int, int] = {}
        self._next_id = 0

    def _decode(self, token, pos):
        with torch.inference_mode():
            logits, self.caches = tfm.decode_step(self.cfg, self.params,
                                                  token, self.caches, pos)
        return logits

    def submit(self, prompt_tokens) -> int | None:
        """Fill a free slot with one request's prompt; returns its id, or
        None when every slot is taken."""
        try:
            slot = self.active.index(False)
        except ValueError:
            return None
        rid = self._next_id
        self._next_id += 1
        for t, tok in enumerate(prompt_tokens):
            tok_arr = self.cur.clone()
            tok_arr[slot, 0] = int(tok)
            pos_arr = self.pos.clone()
            pos_arr[slot] = t
            logits = self._decode(tok_arr, pos_arr)
        self.pos[slot] = len(prompt_tokens)
        nxt = int(torch.argmax(logits[slot]))
        self.cur[slot, 0] = nxt
        self.active[slot] = True
        self.outputs[rid] = [nxt]
        self._slot_of[rid] = slot
        return rid

    def step(self, stop_len: int = 16) -> list:
        """One decode step for every slot; returns the ids that finished."""
        logits = self._decode(self.cur, self.pos)
        nxt = torch.argmax(logits, dim=-1)
        self.cur = nxt[:, None]
        self.pos = self.pos + torch.tensor(
            [1 if a else 0 for a in self.active], device=self.device)
        nxt, pos = nxt.tolist(), self.pos.tolist()
        done = []
        for rid, slot in list(self._slot_of.items()):
            if not self.active[slot]:
                continue
            self.outputs[rid].append(nxt[slot])
            if len(self.outputs[rid]) >= stop_len or \
                    pos[slot] >= self.max_len - 1:
                self.active[slot] = False
                done.append(rid)
                del self._slot_of[rid]
        return done

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

The reference's sharding fields (``param_specs``, ``cache_spec_tree``,
``token_spec``) need ``runtime/sharding.py``'s mesh, which the port has
not yet (ROADMAP.md, queue 1): on one device they are None.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models import transformer as tfm
from repro_torch.models.common import ModelConfig, ShapeDtype, abstract_params
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
                      device=None) -> ServeBuild:
    """The prefill and decode steps for ``batch`` rows of at most
    ``max_len`` positions on ``device`` (None: the card)."""
    dev = resolve_device(device)
    fp32_products()

    def prefill_fn(params, tokens, extras):
        with torch.inference_mode():
            caches = tfm.init_caches(cfg, batch, max_len, device=dev)
            return tfm.prefill(cfg, params, tokens, caches, **extras)

    def decode_fn(params, caches, token, pos, extras):
        with torch.inference_mode():
            return tfm.decode_step(cfg, params, token, caches, pos, **extras)

    def cast_params(params):
        with torch.inference_mode():
            return tfm.cast_for_serving(cfg, params)

    return ServeBuild(
        prefill=prefill_fn,
        decode=decode_fn,
        abstract_params=abstract_params(tfm.model_defs(cfg),
                                        cfg.param_dtype),
        abstract_caches=tfm.init_cache_defs(cfg, batch, max_len),
        cast_params=cast_params,
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

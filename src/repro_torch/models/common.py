"""Model substrate: the config, parameter definitions, init and the
numerics shared by blocks (the port of ``repro/models/common.py``).

Parameters are nested dicts and tuples of tensors, the reference's pytree
layout. ``tree_leaves_with_path`` walks them in ``jax.tree_util``'s order
(dict keys sorted, tuples in order), which is the order of the flat
``ravel_pytree`` row, so bucket cuts and parity tests line up with the
reference. The mesh helpers (``partition_specs``, ``make_rules``) belong to
the multi-pod slice and are not ported yet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared: int = 0
    d_expert: int = 0            # per-expert FFN width
    capacity_factor: float = 1.25
    dispatch_groups: int = 16    # grouped dispatch: the routing cumsum (a
                                 # slot's rank within its expert) runs per
                                 # group, which fixes each group's capacity
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD."""
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    d_conv: int = 4
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma RG-LRU recurrent block."""
    width: int = 2560            # lru width (= d_model for recurrentgemma)
    d_conv: int = 4
    c: float = 8.0               # power in a_t = a^(c·r_t)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    # layer pattern, cycled over n_layers: "attn" (global), "local"
    # (sliding window), "mla" (DeepSeek-V2's latent attention), "ssm"
    # (Mamba-2), "rglru" (Griffin's RG-LRU block). There is no MoE kind:
    # with ``moe`` set every non-SSM layer's FFN is the MoE FFN
    pattern: tuple = ("attn",)
    window: int = 1024           # sliding window for "local" layers
    rope_theta: float = 10_000.0
    rope_theta_global: float = 0.0   # 0 -> same as rope_theta
    mrope_sections: Optional[tuple] = None
    qkv_bias: bool = False
    qk_norm: bool = False        # gemma3
    act: str = "silu"            # silu (swiglu) | gelu (geglu)
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    # precisions
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    fsdp: bool = False
    patch_embed_tokens: int = 0
    loss_chunk: int = 32768
    remat: str = "full"          # "none" keeps every layer's activations;
                                 # any other value checkpoints each period
                                 # slot ("dots" is "full", as in the
                                 # reference: no policy)
    attn_q_block: int = 512
    attn_kv_block: int = 1024
    moe_ep: bool = True

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def layer_kinds(self) -> tuple:
        """Concrete per-layer kind list, cycling ``pattern``."""
        reps = math.ceil(self.n_layers / len(self.pattern))
        return tuple((self.pattern * reps)[: self.n_layers])

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def remainder_kinds(self) -> tuple:
        r = self.n_layers % len(self.pattern)
        return tuple(self.pattern[:r])


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple
    logical: tuple               # logical axis name per dim
    init: str = "normal"         # normal | zeros | ones
    scale: float = 1.0

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} vs axes {self.logical}")


@dataclasses.dataclass(frozen=True)
class ShapeDtype:
    """A tensor's shape and dtype without its storage (the reference's
    ``jax.ShapeDtypeStruct``)."""
    shape: tuple
    dtype: Any


# ---------------------------------------------------------------------------
# pytrees of dicts and tuples
# ---------------------------------------------------------------------------

def tree_leaves_with_path(tree, path=()):
    """``[(path, leaf)]`` in ``jax.tree_util`` order: dict keys sorted,
    tuples and lists in order."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in tree_leaves_with_path(tree[k], path + (k,))]
    if isinstance(tree, (tuple, list)):
        return [item for i, sub in enumerate(tree)
                for item in tree_leaves_with_path(sub, path + (i,))]
    return [(path, tree)]


def tree_map(fn, tree):
    """``fn`` over the leaves, keeping the dict / tuple structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(tree_map(fn, v) for v in tree)
    return fn(tree)


def init_params(defs, generator: torch.Generator, dtype=torch.float32,
                device=None):
    """Materialize a ParamDef pytree: zeros / ones, or a normal truncated to
    [−2, 2] standard deviations with ``std = scale / sqrt(fan_in)``, where
    ``fan_in = shape[-2]`` of the (stacked) shape, as the reference draws
    it. Leaves are drawn in tree order from ``generator`` on the
    generator's device (a CPU generator gives the same values for every
    target device) and moved to ``device``; torch cannot redraw JAX's
    threefry bits, so runs held against the reference carry its params
    across."""
    gen_dev = generator.device

    def one(d: ParamDef):
        if d.init == "zeros":
            t = torch.zeros(d.shape, dtype=torch.float32, device=gen_dev)
        elif d.init == "ones":
            t = torch.ones(d.shape, dtype=torch.float32, device=gen_dev)
        else:
            fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
            std = d.scale / math.sqrt(max(fan_in, 1))
            t = torch.empty(d.shape, dtype=torch.float32, device=gen_dev)
            torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                        generator=generator)
            t *= std
        return t.to(device=device, dtype=dtype)

    out = {}
    for path, d in tree_leaves_with_path(defs):
        out[path] = one(d)
    return _rebuild(defs, out)


def abstract_params(defs, dtype):
    """The ParamDef pytree as ``ShapeDtype`` records (no storage)."""
    return tree_map(lambda d: ShapeDtype(tuple(d.shape), dtype), defs)


def tree_unflatten(structure, leaves):
    """The pytree of ``structure``'s shape whose leaves, in
    ``tree_leaves_with_path`` order, are ``leaves``."""
    paths = [p for p, _ in tree_leaves_with_path(structure)]
    if len(paths) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves for a tree of {len(paths)}")
    return _rebuild(structure, dict(zip(paths, leaves)))


def _rebuild(tree, by_path, path=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, by_path, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_rebuild(v, by_path, path + (i,))
                     for i, v in enumerate(tree))
    return by_path[path]


# ---------------------------------------------------------------------------
# numerics helpers shared by blocks
# ---------------------------------------------------------------------------

def rms_norm(x, gamma, eps=1e-6):
    """f32 inside, ``(1 + γ)`` scale, cast back to ``x``'s dtype."""
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * (1.0 + gamma.to(torch.float32))
    return out.to(x.dtype)


def softcap(x, cap: float):
    if not cap:
        return x
    return torch.tanh(x / cap) * cap


def _gelu_tanh(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    return {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu}[name]

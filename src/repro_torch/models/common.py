"""Model substrate: the config, parameter definitions, init and the
numerics shared by blocks (the port of ``repro/models/common.py``).

Parameters are nested dicts and tuples of tensors, the reference's pytree
layout. ``tree_leaves_with_path`` walks them in ``jax.tree_util``'s order
(dict keys sorted, tuples in order), which is the order of the flat
``ravel_pytree`` row, so bucket cuts and parity tests line up with the
reference. ``make_rules`` and ``partition_specs`` map each parameter's
logical axes to mesh axes (``PartitionSpec``, the port's own tuple of mesh
axis names per dim), as the reference's do.
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


class PartitionSpec(tuple):
    """A mesh axis name (or a tuple of them, or None) per tensor dim: the
    port's counterpart of ``jax.sharding.PartitionSpec``. It compares equal
    to a tuple (and to the reference's spec) of the same entries."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"

    def __reduce__(self):
        return (PartitionSpec, tuple(self))


P = PartitionSpec


def is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


def spec_tree_map(fn, tree):
    """``fn`` over the ``PartitionSpec`` leaves of a dict / tuple tree."""
    if is_spec(tree) or tree is None:
        return fn(tree)
    if isinstance(tree, dict):
        return {k: spec_tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(spec_tree_map(fn, v) for v in tree)
    return fn(tree)


def spec_leaves(tree) -> list:
    """The ``PartitionSpec`` leaves in ``jax.tree_util`` order (dict keys
    sorted, tuples in order)."""
    if is_spec(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in spec_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in spec_leaves(v)]
    return [tree]


def partition_specs(defs, rules: dict):
    """Map each ParamDef's logical axes to mesh axes via ``rules``.

    ``rules`` maps a logical axis name to a mesh axis name (or None). A
    mesh axis is used at most once per param (the first logical dim wins)
    and only where the dim divides the axis size (``make_rules`` puts the
    sizes into the rules).

    Selective FSDP (``rules["_fsdp_axis"]``): after the TP assignment, the
    largest still-unsharded eligible dim also shards over the data axis,
    except on vocab-carrying params (the embedding's token gather stays on
    a table sharded one way only).
    """
    fsdp_axis = rules.get("_fsdp_axis")

    def spec(d: ParamDef) -> PartitionSpec:
        used = set()
        axes = []
        for dim, logical in zip(d.shape, d.logical):
            ax = rules.get(logical)
            if ax is None or ax in used:
                axes.append(None)
                continue
            size = rules.get(("_axis_size", ax), 0)
            if size and dim % size != 0:
                axes.append(None)
                continue
            axes.append(ax)
            used.add(ax)
        if fsdp_axis and fsdp_axis not in used \
                and "vocab" not in d.logical:
            dsize = rules.get(("_axis_size", fsdp_axis), 0)
            cands = [
                (dim, i) for i, (dim, logical)
                in enumerate(zip(d.shape, d.logical))
                if axes[i] is None and logical not in ("layers", "conv")
                and dsize and dim % dsize == 0
            ]
            if cands:
                _, i = max(cands)
                axes[i] = fsdp_axis
        return PartitionSpec(*axes)

    return tree_map(spec, defs)


def make_rules(cfg: ModelConfig, mesh_axes: dict) -> dict:
    """Logical-axis -> mesh-axis rules for a model on a mesh.

    mesh_axes: ``{"data": size, "model": size}`` (the pod axis is handled
    outside). TP axes go on ``model``; with ``cfg.fsdp`` the ``_fsdp_axis``
    post-pass of ``partition_specs`` also shards over ``data``. Experts go
    on ``data`` (EP) when their count divides it.
    """
    model_size = mesh_axes.get("model", 1)
    data_size = mesh_axes.get("data", 1)
    rules = {
        "vocab": "model",
        "ff": "model",
        "expert_ff": "model",
        "experts": "data" if (cfg.moe and cfg.moe_ep and cfg.moe.n_experts
                              % max(data_size, 1) == 0) else None,
        "q_heads": "model",
        "kv_heads": "model",
        "heads_x_dim": "model",
        "inner": "model",        # ssm / rglru inner channels
        "embed": None,           # fsdp: the _fsdp_axis post-pass
        "embed_out": None,
        "layers": None,
        "head_dim": None,
        "state": None,
        "conv": None,
        "lora": None,
        ("_axis_size", "model"): model_size,
        ("_axis_size", "data"): data_size,
    }
    if cfg.fsdp:
        rules["_fsdp_axis"] = "data"
    return rules


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

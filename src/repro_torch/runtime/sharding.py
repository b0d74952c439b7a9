"""Sharding rules: logical axes -> mesh ``PartitionSpec``s for params,
batches and serving caches, and the placements that carry them out (the
port of ``repro/runtime/sharding.py``).

Mesh axes: optional ``pod`` (EASGD workers), ``data`` (intra-pod DP and
FSDP), ``model`` (TP). The divisibility checks live here, so every arch maps
onto any mesh: a dim that does not divide its axis stays replicated. The
spec functions are pure functions of ``cfg`` and the mesh's axis sizes: a
``DeviceMesh``, or any object with the reference's ``axis_names`` and
``devices.shape``, will do.

What carries a spec out on the port's mesh of processes:

* ``placements`` / ``named``: a spec as DTensor placements (``Shard(dim)``
  on each mesh dim that the spec names, else ``Replicate()``);
* ``local_shape`` / ``local_shard``: the block of a global tensor that this
  rank holds (even blocks, DTensor's layout), ``gather_full`` the global
  tensor back (``DTensor.from_local(...).full_tensor()``);
* ``time_splits``: where a serving cache's block lies along its time dim,
  for flash-decoding (``models.tp.TimeSplit``);
* ``with_sharding_constraint``: a local tensor gathered over the axes its
  source spec names and the target does not (the streaming-FSDP
  all-gather of ``block_constrainer``, whose backward is the
  reduce-scatter), else returned as it is: the model runs on local
  shards, whose layout the explicit collectives of ``models.tp`` make.
  ``activation_constrainer`` gives the reference's spec at each
  ``sctx.shard`` point; the runtimes install none.
"""
from __future__ import annotations

import math

from repro_torch.launch.mesh import axis_sizes
from repro_torch.models import transformer as tfm
from repro_torch.models.common import (ModelConfig, PartitionSpec as P,
                                       make_rules, partition_specs,
                                       spec_leaves, spec_tree_map,
                                       tree_leaves_with_path, tree_unflatten)


def mesh_axis_sizes(mesh) -> dict:
    return axis_sizes(mesh)


def param_specs(cfg: ModelConfig, mesh):
    """PartitionSpecs for the model parameter pytree (no pod dim)."""
    sizes = mesh_axis_sizes(mesh)
    rules = make_rules(cfg, sizes)
    return partition_specs(tfm.model_defs(cfg), rules)


def local_layout(cfg: ModelConfig, mesh) -> list:
    """``[(path, local shape)]`` of this rank's flat row on ``mesh``, in
    ``transformer.ravel_layout``'s order."""
    sizes = mesh_axis_sizes(mesh)
    specs = spec_leaves(param_specs(cfg, mesh))
    return [(path, local_shape(shape, spec, sizes)) for (path, shape), spec
            in zip(tfm.ravel_layout(cfg), specs)]


def _div(n: int, size: int) -> bool:
    return size > 1 and n % size == 0


def batch_specs(cfg: ModelConfig, mesh, *, pod_dim: bool):
    """Specs for a training batch with leading (n_pods, B_local, S) dims."""
    pod = "pod" if (pod_dim and "pod" in mesh_axis_sizes(mesh)) else None
    tok = P(pod, "data", None)
    specs = {"tokens": tok, "targets": tok, "mask": tok}
    if cfg.mrope_sections is not None:
        specs["mrope_positions"] = P(pod, None, "data", None)
    if cfg.patch_embed_tokens:
        specs["patch_embeds"] = P(pod, "data", None, None)
    return specs


def serve_token_specs(cfg: ModelConfig, mesh, B: int):
    sizes = mesh_axis_sizes(mesh)
    b_ax = "data" if _div(B, sizes.get("data", 1)) else None
    return P(b_ax, None)


def cache_specs(cfg: ModelConfig, mesh, B: int, max_len: int):
    """PartitionSpecs mirroring ``transformer.init_cache_defs``.

    Batch shards over ``data`` when divisible; otherwise (long-context
    decode with B 1) the SEQUENCE dim of attention / MLA caches shards over
    ``data`` (flash-decoding). Head and feature dims shard over ``model``
    when divisible, else the time dim takes ``model`` too.
    """
    sizes = mesh_axis_sizes(mesh)
    dsz, msz = sizes.get("data", 1), sizes.get("model", 1)
    b_ax = "data" if _div(B, dsz) else None

    def seq_ax(S, *, model_free: bool):
        axes = []
        if b_ax is None and _div(S, dsz):
            axes.append("data")
        if model_free and _div(S, msz * (dsz if axes else 1)):
            axes.append("model")
        if not axes:
            return None
        return tuple(axes) if len(axes) > 1 else axes[0]

    def kind_spec(kind: str):
        if kind in ("attn", "local"):
            S = max_len if kind == "attn" else min(cfg.window, max_len)
            kv_ax = "model" if _div(cfg.n_kv_heads, msz) else None
            s = P(b_ax, seq_ax(S, model_free=kv_ax is None), kv_ax, None)
            return {"k": s, "v": s}
        if kind == "mla":
            a = cfg.mla
            rank_ax = "model" if _div(a.kv_lora_rank, msz) else None
            return {
                "ckv": P(b_ax, seq_ax(max_len, model_free=rank_ax is None),
                         rank_ax),
                "kpe": P(b_ax, seq_ax(max_len, model_free=False), None),
            }
        if kind == "ssm":
            s = cfg.ssm
            d_inner = s.expand * cfg.d_model
            H = d_inner // s.head_dim
            conv_dim = d_inner + 2 * s.d_state
            return {
                "conv": P(b_ax, None,
                          "model" if _div(conv_dim, msz) else None),
                "state": P(b_ax, "model" if _div(H, msz) else None, None,
                           None),
            }
        if kind == "rglru":
            g = cfg.rglru
            w_ax = "model" if _div(g.width, msz) else None
            return {"conv": P(b_ax, None, w_ax), "state": P(b_ax, w_ax)}
        raise ValueError(kind)

    def stack(spec_tree):
        return spec_tree_map(lambda s: P(None, *s), spec_tree)

    return {
        "stacked": tuple(stack(kind_spec(k)) for k in cfg.pattern),
        "rem": tuple(kind_spec(k) for k in cfg.remainder_kinds),
    }


# ---------------------------------------------------------------------------
# placements: a spec on this rank
# ---------------------------------------------------------------------------

def _axes_of(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def spec_axes(spec) -> set:
    """The mesh axes a spec names."""
    return {a for entry in spec for a in _axes_of(entry)}


def _names(mesh) -> list:
    return list(mesh_axis_sizes(mesh))


def placements(mesh, spec) -> tuple:
    """A ``PartitionSpec`` as DTensor placements, one per mesh dim. A dim
    split over several axes must name them in the mesh's order (DTensor's
    nesting)."""
    from torch.distributed.tensor import Replicate, Shard
    names = _names(mesh)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        idx = [names.index(a) for a in _axes_of(entry)]
        if idx != sorted(idx):
            raise NotImplementedError(f"{spec}: axes out of the mesh's "
                                      f"order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


def named(mesh, spec_tree):
    """A PartitionSpec tree as a tree of DTensor placements."""
    return spec_tree_map(
        lambda s: None if s is None else placements(mesh, s), spec_tree)


def local_shape(shape, spec, sizes: dict) -> tuple:
    """The shape of one rank's block of a ``shape`` tensor laid out by
    ``spec`` on a mesh of ``sizes``."""
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        n = math.prod(sizes.get(a, 1) for a in _axes_of(entry))
        if dim % n:
            raise ValueError(f"dim {dim} does not split over {entry}")
        out.append(dim // n)
    return tuple(out)


def local_slices(mesh, shape, spec) -> tuple:
    """This rank's block of a ``shape`` tensor as one slice per dim."""
    sizes = mesh_axis_sizes(mesh)
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = _axes_of(entry)
        idx, n = 0, 1
        for a in axes:
            idx = idx * sizes[a] + mesh.get_local_rank(a)
            n *= sizes[a]
        block = dim // n
        out.append(slice(idx * block, (idx + 1) * block))
    return tuple(out)


def time_splits(cfg: ModelConfig, mesh, B: int, max_len: int) -> dict:
    """The caches whose time dim ``cache_specs`` splits (flash-decoding),
    as ``{cache: (axes, block index, block length, whole length)}``, keyed
    ``attn`` / ``local`` (a dense layer's ``k`` and ``v``), ``ckv`` and
    ``kpe`` (MLA's): the axes in the spec's nesting order, the rest read
    off this rank's block by ``local_slices``. Every layer of a kind has
    its kind's split."""
    specs = cache_specs(cfg, mesh, B, max_len)
    defs = tfm.init_cache_defs(cfg, B, max_len)
    out = {}
    for kinds, part, lead in ((cfg.pattern, "stacked", 1),
                              (cfg.remainder_kinds, "rem", 0)):
        for kind, spec, d in zip(kinds, specs[part], defs[part]):
            for name in ("k", "ckv", "kpe"):
                if name not in spec or spec[name][lead + 1] is None:
                    continue
                shape = d[name].shape
                sl = local_slices(mesh, shape, spec[name])[lead + 1]
                block = sl.stop - sl.start
                out[kind if name == "k" else name] = (
                    _axes_of(spec[name][lead + 1]), sl.start // block, block,
                    shape[lead + 1])
    return out


def local_shard(t, mesh, spec):
    """This rank's block of the global tensor ``t`` (a view)."""
    return t[local_slices(mesh, t.shape, spec)]


def gather_full(local, mesh, spec):
    """The global tensor whose block on each rank is ``local``."""
    from torch.distributed.tensor import DTensor
    sizes = mesh_axis_sizes(mesh)
    if all(sizes[a] == 1 for e in spec for a in _axes_of(e)):
        return local
    return DTensor.from_local(local, mesh, placements(mesh, spec),
                              run_check=False).full_tensor()


def with_sharding_constraint(x, mesh, spec, src=None):
    """Lay the local tensor ``x`` out by ``spec``: where its source layout
    ``src`` names an axis on a dim that ``spec`` leaves whole, it is
    all-gathered over it (autograd: the backward reduce-scatters); else
    it is returned as it is."""
    if src is None:
        return x
    from repro_torch.models import tp
    sizes = mesh_axis_sizes(mesh)
    for dim, (have, want) in enumerate(zip(src, spec)):
        if have == want:
            continue
        if want is not None or len(_axes_of(have)) != 1:
            raise NotImplementedError(f"local {src} -> {spec}")
        if sizes[have] > 1:
            x = tp.all_gather(x, dim, mesh.get_group(have))
    return x


def activation_constrainer(cfg: ModelConfig, mesh):
    """The reference's ``models.sctx`` constraint fn: logical activation
    axes -> PartitionSpec on this mesh. batch / groups -> data, heads / ff
    / vocab / inner -> model, experts_dp -> data (EP buffers, taking
    priority over groups). Dims that do not divide their axis stay
    replicated. On the port's local shards the spec changes nothing (the
    layout is ``models.tp``'s), so the runtimes do not install it; it is
    held to the reference's specs by tests/test_torch_sharding.py."""
    sizes = mesh_axis_sizes(mesh)
    dsz, msz = sizes.get("data", 1), sizes.get("model", 1)

    data_axes = {"experts_dp": 0, "batch": 2, "groups": 2}
    model_axes = {"heads": 1, "kv_heads": 1, "ff": 1, "vocab": 1,
                  "experts": 1, "inner": 1}

    def fn(x, logical):
        axes = [None] * len(logical)
        used = set()
        order = sorted(
            range(len(logical)),
            key=lambda i: data_axes.get(logical[i],
                                        model_axes.get(logical[i], 9)))
        for i in order:
            dim, name = x.shape[i], logical[i]
            if name in data_axes and "data" not in used and dim % dsz == 0:
                axes[i] = "data"
                used.add("data")
            elif name in model_axes and "model" not in used \
                    and dim % msz == 0:
                axes[i] = "model"
                used.add("model")
        return with_sharding_constraint(x, mesh, P(*axes))

    return fn


def block_constrainer(cfg: ModelConfig, mesh):
    """Streaming FSDP: ``constrain(kind, params_subtree)`` re-lays one
    layer's params out in their COMPUTE layout (TP only, no ``data``
    factor): one all-gather per FSDP-sharded leaf per layer per pass, whose
    backward reduce-scatters the weight gradients (ZeRO-3). The port's
    ``constrain`` also takes the name of a top-level leaf (``final_norm``,
    ``embed``, ``unembed``) for the leaves outside the blocks. Returns None
    when ``cfg.fsdp`` is off."""
    if not cfg.fsdp:
        return None
    sizes = mesh_axis_sizes(mesh)
    store = make_rules(cfg, sizes)
    rules = dict(store)
    rules.pop("_fsdp_axis", None)
    spec_cache, src_cache = {}, {}
    for kind in set(cfg.pattern) | set(cfg.remainder_kinds):
        spec_cache[kind] = spec_leaves(partition_specs(
            tfm._block_defs(cfg, kind), rules))
        src_cache[kind] = spec_leaves(partition_specs(
            tfm._block_defs(cfg, kind), store))
    top = {k: v for k, v in tfm.model_defs(cfg).items()
           if k not in ("blocks", "rem")}
    for name, d in top.items():
        spec_cache[name] = [partition_specs(d, rules)]
        src_cache[name] = [partition_specs(d, store)]

    def constrain(kind, subtree):
        leaves = [t for _, t in tree_leaves_with_path(subtree)]
        specs, srcs = spec_cache[kind], src_cache[kind]
        assert len(leaves) == len(specs), (kind, len(leaves), len(specs))
        out = [with_sharding_constraint(x, mesh, s, src)
               for x, s, src in zip(leaves, specs, srcs)]
        return tree_unflatten(subtree, out)

    return constrain

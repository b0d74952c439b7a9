"""The port's sharding rules (``repro_torch.runtime.sharding``) against the
reference's ``repro.runtime.sharding``: every spec ``==`` the reference's.

On both sides the mesh is a stand-in with ``axis_names`` and
``devices.shape``, which is all the spec functions read, so no device or
process group takes part. The cases: the ten arch ids, full and reduced,
on meshes (16, 16), (2, 16, 16), (2, 2), (4, 2) and (2, 2, 2), each for

* ``param_specs``;
* ``batch_specs`` with and without the pod dim, and ``serve_token_specs``
  at B 1, 2, 8 and 32;
* ``cache_specs`` at B 1, 2, 8 and 32 and ``max_len`` 32, 1000 and 4096
  (B 1 takes the flash-decoding split of the time dim);
* ``activation_constrainer`` on the logical-axis tuples of the
  reference's ``sctx.shard`` calls, at their shapes for B 1 and 8;
* ``block_constrainer`` on every layer kind of the config, as it is and
  with ``fsdp`` on.

The constrainers' specs are captured where each side applies them: the
reference's ``with_sharding_constraint`` and ``NamedSharding`` are
replaced inside the test through ``monkeypatch`` (nothing in ``src/repro``
changes), the port's ``with_sharding_constraint`` likewise.
"""
import dataclasses
import types

import numpy as np
import pytest

from repro import configs as ref_configs
from repro.models import transformer as ref_tfm
from repro.runtime import sharding as ref_shd
from repro_torch import configs
from repro_torch.models import transformer as tfm
from repro_torch.runtime import sharding as shd

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "4x2": ((4, 2), ("data", "model")),
    "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
}
ARCHS = sorted(ref_configs.ARCHS)
WHAT = ("params", "batch", "caches", "activations", "blocks")


def _mesh(name):
    shape, axes = MESHES[name]
    return types.SimpleNamespace(axis_names=axes, devices=np.empty(shape))


def _cfgs(arch, size):
    ref, port = ref_configs.get(arch), configs.get(arch)
    return (ref.reduced, port.reduced) if size == "reduced" \
        else (ref.config, port.config)


def _flat(tree):
    """Spec leaves in tree order (dict keys sorted), as plain tuples;
    None stays None."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if tree is None:
        return [None]
    if type(tree) is tuple:
        return [x for v in tree for x in _flat(v)]
    return [tuple(tree)]


def _same(got, want):
    assert _flat(got) == _flat(want)
    assert len(_flat(got)) == len(_flat(want))


def _probes(cfg, B):
    """(shape, logical axes) of the reference's sctx.shard points."""
    S, d, D = 16, cfg.d_model, cfg.resolved_head_dim
    out = [((B, S, d), ("batch", "seq", "embed")),
           ((B, S, cfg.n_heads, D), ("batch", "seq", "heads", "head_dim")),
           ((B, S, cfg.n_kv_heads, D),
            ("batch", "seq", "kv_heads", "head_dim")),
           ((B, S, cfg.d_ff), ("batch", "seq", "ff")),
           ((B, S, cfg.vocab_size), ("batch", "seq", "vocab"))]
    if cfg.ssm is not None:
        inner = cfg.ssm.expand * d
        out += [((B, S, inner), ("batch", "seq", "inner")),
                ((B, S, inner // cfg.ssm.head_dim, cfg.ssm.head_dim),
                 ("batch", "seq", "heads", "head_dim"))]
    if cfg.rglru is not None:
        out.append(((B, S, cfg.rglru.width), ("batch", "seq", "inner")))
    if cfg.moe is not None:
        m = cfg.moe
        G, E, C = m.dispatch_groups, m.n_experts, 8
        ex = "experts_dp" if cfg.moe_ep else "experts_off"
        out += [((G, E, C, d), ("groups", ex, "cap", "embed")),
                ((G, E, C, m.d_expert), ("groups", ex, "cap", "ff")),
                ((G, E * C, d), ("groups", "cap", "embed"))]
    return out


@pytest.mark.parametrize("what", WHAT)
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("size", ["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_reference(arch, size, mesh_name, what, monkeypatch):
    rcfg, pcfg = _cfgs(arch, size)
    mesh = _mesh(mesh_name)
    if what == "params":
        got, want = shd.param_specs(pcfg, mesh), ref_shd.param_specs(rcfg,
                                                                    mesh)
        _same(got, want)
        assert len(_flat(got)) == len(tfm.ravel_layout(pcfg))
    elif what == "batch":
        for pod_dim in (True, False):
            _same(shd.batch_specs(pcfg, mesh, pod_dim=pod_dim),
                  ref_shd.batch_specs(rcfg, mesh, pod_dim=pod_dim))
        for B in (1, 2, 8, 32):
            _same(shd.serve_token_specs(pcfg, mesh, B),
                  ref_shd.serve_token_specs(rcfg, mesh, B))
    elif what == "caches":
        for B in (1, 2, 8, 32):
            for max_len in (32, 1000, 4096):
                got = shd.cache_specs(pcfg, mesh, B, max_len)
                _same(got, ref_shd.cache_specs(rcfg, mesh, B, max_len))
                defs = tfm.init_cache_defs(pcfg, B, max_len)
                assert [len(s) for s in _flat(got)] == [
                    len(d.shape) for d in _flat_defs(defs)]
    elif what == "activations":
        seen = {"ref": [], "port": []}
        monkeypatch.setattr(ref_shd, "NamedSharding", lambda m, s: s)
        monkeypatch.setattr(ref_shd.jax.lax, "with_sharding_constraint",
                            lambda x, s: seen["ref"].append(tuple(s)) or x)
        monkeypatch.setattr(shd, "with_sharding_constraint",
                            lambda x, m, s, src=None:
                            seen["port"].append(tuple(s)) or x)
        ref_fn = ref_shd.activation_constrainer(rcfg, mesh)
        port_fn = shd.activation_constrainer(pcfg, mesh)
        for B in (1, 8):
            for shape, logical in _probes(rcfg, B):
                x = types.SimpleNamespace(shape=shape)
                ref_fn(x, logical)
                port_fn(x, logical)
        assert seen["port"] == seen["ref"] and seen["ref"]
    else:
        seen = []
        monkeypatch.setattr(ref_shd, "NamedSharding", lambda m, s: s)
        monkeypatch.setattr(ref_shd.jax.lax, "with_sharding_constraint",
                            lambda x, s: s)
        monkeypatch.setattr(shd, "with_sharding_constraint",
                            lambda x, m, s, src=None: seen.append(src) or s)
        for fsdp in (rcfg.fsdp, True):
            rc = dataclasses.replace(rcfg, fsdp=fsdp)
            pc = dataclasses.replace(pcfg, fsdp=fsdp)
            ref_c = ref_shd.block_constrainer(rc, mesh)
            port_c = shd.block_constrainer(pc, mesh)
            assert (ref_c is None) == (port_c is None) == (not fsdp)
            if ref_c is None:
                continue
            for kind in sorted(set(rc.pattern) | set(rc.remainder_kinds)):
                _same(port_c(kind, tfm._block_defs(pc, kind)),
                      ref_c(kind, ref_tfm._block_defs(rc, kind)))
        assert all(src is not None for src in seen)


def _flat_defs(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat_defs(tree[k])]
    if isinstance(tree, tuple):
        return [x for v in tree for x in _flat_defs(v)]
    return [tree]

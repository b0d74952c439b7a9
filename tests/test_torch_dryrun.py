"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's: its cells, parameter counts and model FLOPs; one full-config
cell on a fake world of 256 ranks; serving cells that place (flash-
decoding's among them); and the
FLOP count of two reduced cells held against ``repro.launch.hloparse`` on
the compiled reference step.

Two op classes differ by what each side counts, and the comparison names
them (ROADMAP.md queue 3):

* attention: the reference's blocked attention runs every product of a
  (q_block × kv_block) tile, the masked pairs included, and the compiled
  program's dots count them all; the port counts the pairs its masks
  leave (``costmodel.attn_pairs``), the work the card's kernels need;
* the packed update: ``hloparse`` counts the FLOPs of dots and
  convolutions only, and the port's count adds the elementwise
  operations of ``fused_elastic_update``'s formula.

With those two made the same the totals are equal; as they stand they
are held within 5 %.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap

import pytest

from repro import configs as ref_configs
from repro.core import costmodel as ref_cm
from repro.models import transformer as ref_tfm
from repro_torch import configs
from repro_torch.core import costmodel as cm
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cells_equal_the_reference():
    assert configs.cells() == ref_configs.cells()
    assert len(configs.cells()) == 40
    assert sum(ok for _, _, ok in configs.cells()) == 34


def _ref_count_params(cfg):
    """The reference's ``launch.dryrun.count_params``, re-implemented on
    its ``model_defs`` (importing that module sets XLA_FLAGS)."""
    import jax
    leaves = jax.tree_util.tree_leaves(
        ref_tfm.model_defs(cfg), is_leaf=lambda x: hasattr(x, "logical"))
    total = active = 0
    for d in leaves:
        n = 1
        for s in d.shape:
            n *= s
        total += n
        if cfg.moe is not None and "experts" in d.logical:
            active += n * cfg.moe.top_k / cfg.moe.n_experts
        else:
            active += n
    return int(total), int(active)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_count_params_equal(arch):
    assert dryrun.count_params(configs.get(arch).config) == \
        _ref_count_params(ref_configs.get(arch).config)


def test_model_flops_and_elastic_config():
    for arch in configs.ARCH_IDS:
        _, active = dryrun.count_params(configs.get(arch).config)
        for tokens in (128, 32 * 32768, 256 * 4096):
            assert cm.model_flops_train(active, tokens) == \
                ref_cm.model_flops_train(active, tokens)
            assert cm.model_flops_infer(active, tokens) == \
                ref_cm.model_flops_infer(active, tokens)
    e = dryrun.make_elastic_config(configs.get("gemma3-27b"),
                                   overrides={"compression": "sign_ef"})
    assert (e.easgd.eta, e.easgd.rho, e.easgd.mu, e.easgd.tau, e.mode,
            e.packed, e.overlap, e.compression) == \
        (0.01, 0.01, 0.9, 1, "sync_easgd", True, True, "sign_ef")


RECORD_KEYS = ("n_params", "n_params_active", "model_flops", "roofline",
               "useful_flops_ratio", "roofline_fraction", "wire_model",
               "peak_bytes_per_device", "fits_device", "flops_per_device",
               "bytes_per_device", "collective_bytes_per_device",
               "cross_pod_bytes_per_device", "collective_bytes_by_type",
               "collective_counts", "collective_bytes_by_dtype",
               "cross_pod_bytes_by_dtype", "kernel_regions", "chip")


def test_full_config_cell_on_a_fake_world(tmp_path):
    """gemma3-4b × train_4k × pod at the full config on a fake world of
    256 ranks, one microbatch (the count a microbatch of the step)."""
    out = tmp_path / "cells.jsonl"
    rec = dryrun.run_cell("gemma3-4b", "train_4k", "pod", str(out),
                          microbatches_override=1)
    assert rec["ok"], rec.get("traceback")
    for key in RECORD_KEYS:
        assert key in rec, key
    rl = rec["roofline"]
    assert set(rl) == {"compute_s", "memory_s", "collective_s", "dominant",
                       "bound_s", "cross_pod_s"}
    assert rl["bound_s"] == max(rl["compute_s"], rl["memory_s"],
                                rl["collective_s"]) > 0
    assert 0 < rec["useful_flops_ratio"] <= 1.2
    assert rec["fits_device"] and rec["n_params"] == 3_879_925_248
    assert (rec["mesh"], rec["n_devices"], rec["microbatches"]) == \
        ("16x16", 256, 1)
    assert rec["wire_model"]["auto_schedule_choice"] == "psum"
    assert rec["kernel_regions"]["fused_elastic_update"]["launches"] == 1
    assert json.loads(out.read_text().splitlines()[-1])["ok"]


@pytest.mark.parametrize("arch,shape,mesh_kind", [
    ("mamba2-780m", "prefill_32k", "pod"),
    ("deepseek-v2-236b", "decode_32k", "multipod"),
    ("gemma3-4b", "long_500k", "pod"),
])
def test_serving_cell_places(arch, shape, mesh_kind):
    """Serving cells at one layer: the SSM's and MLA / MoE's caches placed
    by their specs, and gemma3-4b's ``long_500k`` (B 1), whose one local
    layer's ring buffer of 1024 slots splits its time over ``(data,
    model)`` in blocks of 4: flash-decoding's combine is two all-reduces
    a group, the max (B, KVH, G) and then the rescaled terms and sums
    (B, KVH, G, D + 1), f32, and no other cell's collectives carry its
    tag."""
    cfg = dataclasses.replace(configs.get(arch).config, n_layers=1)
    rec = dryrun.run_cell(arch, shape, mesh_kind, cfg_override=cfg)
    assert rec["ok"], rec.get("traceback")
    combine = rec["collectives_by_tag"].get("softmax-combine")
    if arch != "gemma3-4b":
        assert combine is None, combine
        return
    assert cfg.remainder_kinds == ("local",)
    B, KVH, G = 1, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    per_group = 4 * B * KVH * G * (1 + cfg.resolved_head_dim + 1)
    assert combine == {"count": 4, "bytes": 2 * per_group}, combine
    assert rec["collective_counts"]["all-reduce"] >= 4


def test_placed_moe_cell_counts_its_all_to_all():
    """deepseek-v2-236b ``train_4k`` on ``16x16`` at one layer and one
    microbatch: the experts 10 a rank over ``data``, so each MoE layer's
    dispatch and combine are one all-to-all of the rank's ``(G_local, E,
    C, d)`` buffer each, in the compute dtype, in each of the step's
    three passes (forward, the remat recompute, backward)."""
    cfg = dataclasses.replace(configs.get("deepseek-v2-236b").config,
                              n_layers=1)
    rec = dryrun.run_cell("deepseek-v2-236b", "train_4k", "pod",
                          cfg_override=cfg, microbatches_override=1)
    assert rec["ok"], rec.get("traceback")
    m, (data, model) = cfg.moe, (16, 16)
    T = 256 * 4096                           # the microbatch's tokens
    G = min(m.dispatch_groups, T)
    C = math.ceil(T // G * m.top_k * m.capacity_factor / m.n_experts)
    buf = (G // data) * m.n_experts * C * cfg.d_model * 2
    assert rec["collective_counts"]["all-to-all"] == 2 * 3
    assert rec["collective_bytes_by_type"]["all-to-all"] == 2 * 3 * buf
    assert rec["fits_device"]


_REF = r"""
import dataclasses, json
from repro import configs
from repro.core.easgd import EASGDConfig
from repro.core.elastic import ElasticConfig
from repro.launch import hloparse
from repro.runtime.train import build_train_step, make_batch_defs
from repro.utils.jaxcompat import auto_mesh
mesh = auto_mesh((2, 2, 2), ("pod", "data", "model"))
out = {}
for aid in ARCHS:
    cfg = dataclasses.replace(configs.get(aid).reduced, remat="none")
    ecfg = ElasticConfig(easgd=EASGDConfig(eta=0.01, rho=0.01, mu=0.9, tau=1),
                         mode="sync_easgd", packed=True, overlap=True)
    build = build_train_step(cfg, ecfg, mesh, n_pods=2, per_pod_batch=B,
                             seq=S, microbatches=1)
    text = build.step.lower(build.abstract_state,
                            make_batch_defs(cfg, 2, B, S)).compile().as_text()
    c = hloparse.parse_costs(text, pod_stride=4)
    out[aid] = {"flops": c.flops, "cross": c.cross_pod_bytes}
print("REF", json.dumps(out))
"""

ARCHS, B, S = ("gemma3-4b", "qwen2-vl-72b"), 4, 32


@pytest.fixture(scope="module")
def reference_counts():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(REPO, "src"))
    code = f"ARCHS, B, S = {ARCHS!r}, {B}, {S}\n" + textwrap.dedent(_REF)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [x for x in proc.stdout.splitlines() if x.startswith("REF ")][-1]
    return json.loads(line[4:])


def _dense_attention_flops(cfg, rows, heads):
    """What the reference's dense tiles run for the attention calls the
    port counted: every (q, k) pair of each head, forward 2 products,
    backward 5, each 2·D operations a pair."""
    return cfg.n_layers * rows * heads * S * S * 2 * cfg.resolved_head_dim \
        * (2 + 5)


@pytest.mark.parametrize("arch", ARCHS)
def test_flops_against_hloparse(arch, reference_counts):
    """Reduced configs at S 32 on a (pod 2, data 2, model 2) mesh with
    remat "none" on both sides: the port's count of rank 0's step against
    ``parse_costs`` of the reference's compiled step, per device."""
    cfg = dataclasses.replace(configs.get(arch).reduced, remat="none")
    ecfg = dryrun.make_elastic_config(configs.get(arch))
    with dryrun.fake_world(8):
        mesh = make_host_mesh(2, 2, 2, device="cpu")
        costs, _ = dryrun.count_step(lambda: dryrun.train_step(
            cfg, ecfg, n_pods=2, per_pod_batch=B, seq=S, mesh=mesh),
            pod_stride=4)
    ref = reference_counts[arch]
    assert abs(costs.flops / ref["flops"] - 1) <= 0.05, \
        (costs.flops, ref["flops"])
    # the two named op classes made the same: then equal
    reg = costs.regions
    port_attn = sum(reg[k]["operations"] for k in ("flash_attention_fwd",
                                                   "flash_attention_bwd"))
    rows = B // 2                           # this rank's rows (data 2)
    heads = cfg.n_heads // 2                # its q heads (model 2)
    dense = _dense_attention_flops(cfg, rows, heads)
    update = reg["fused_elastic_update"]["operations"]
    assert costs.flops - port_attn - update + dense == ref["flops"]
    # the cross-pod bytes: the exchange's row and the metrics' sums
    assert abs(costs.cross_pod_bytes - ref["cross"]) <= 64, \
        (costs.cross_pod_bytes, ref["cross"])


def test_perf_variants_run_through_run_cell(tmp_path, monkeypatch):
    """``launch.perf``: the reference's twelve variants of cells A, B and
    C; cell B's (deepseek-v2-236b) three run, each cut here to one layer
    and one microbatch, and the variant without EP counts no
    all-to-all."""
    from repro_torch.launch import perf
    full = perf.variants()
    names = [v[1] for v in full]
    assert len(names) == 12 and names[0] == "A1_bigger_attn_blocks"

    def cut(item):
        cell, name, eo, tf = item[:4]
        return (cell, name, eo, lambda c: dataclasses.replace(
            tf(c) if tf else c, n_layers=1), 1)
    monkeypatch.setattr(perf, "variants", lambda: [cut(v) for v in full])
    out = tmp_path / "perf.jsonl"
    perf.main(["--only", "deepseek", "--out", str(out)])
    recs = [json.loads(x) for x in out.read_text().splitlines()]
    assert [r["variant"] for r in recs] == [
        "B1_no_ep_expert_tp", "B2_capacity_1.0", "B3_ep_and_cap1_bigblocks"]
    assert all(r["ok"] for r in recs), [r.get("error") for r in recs]
    a2a = [r["collective_bytes_by_type"].get("all-to-all", 0) for r in recs]
    assert a2a[0] == 0 and a2a[1] > 0 and a2a[1] == a2a[2], a2a

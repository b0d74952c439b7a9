"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's: its cells, parameter counts and model FLOPs; one full-config
cell on a fake world of 256 ranks; a cell the port cannot place; and the
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


@pytest.mark.parametrize("arch,shape,mesh_kind,what", [
    ("mamba2-780m", "train_4k", "pod", "['ssm']"),
    ("deepseek-v2-236b", "train_4k", "multipod", "['mla', 'moe']"),
    ("gemma3-4b", "long_500k", "pod", "flash-decoding"),
])
def test_unplaced_cell_is_recorded_not_skipped(arch, shape, mesh_kind,
                                               what):
    rec = dryrun.run_cell(arch, shape, mesh_kind)
    assert rec["ok"] is False
    assert rec["error"].startswith("NotImplementedError") and \
        what in rec["error"]


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


def test_perf_variants_run_through_run_cell(tmp_path):
    """``launch.perf``: the reference's twelve variants of cells A, B and
    C; cell B (deepseek-v2-236b) records its NotImplementedError."""
    from repro_torch.launch import perf
    names = [v[1] for v in perf.variants()]
    assert len(names) == 12 and names[0] == "A1_bigger_attn_blocks"
    out = tmp_path / "perf.jsonl"
    perf.main(["--only", "deepseek", "--out", str(out)])
    recs = [json.loads(x) for x in out.read_text().splitlines()]
    assert [r["variant"] for r in recs] == [
        "B1_no_ep_expert_tp", "B2_capacity_1.0", "B3_ep_and_cap1_bigblocks"]
    assert all(not r["ok"] and r["error"].startswith("NotImplementedError")
               for r in recs)

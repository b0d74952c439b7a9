"""The port's cost model (``repro_torch.core.costmodel``) against the
reference's (``repro.core.costmodel``): every ported α–β schedule cost, the
paper's networks and chips, the roofline and the model FLOPs, equal on a
grid of sizes, participant counts, networks and chips; and the kernels'
work formulas against their definitions."""
import dataclasses
import itertools

import pytest

from repro.core import costmodel as ref
from repro_torch.core import costmodel as cm

SIZES = (0.0, 1.0, 4096.0, 6_976_842 * 4.0, 3.2e9)
PS = (1, 2, 3, 4, 8, 16, 64, 256)
NETS = ("MELLANOX_FDR", "INTEL_QDR", "INTEL_10GBE", "PS_WIRE")
SCHEDULES = ("t_msg", "t_round_robin", "t_round_robin_allreduce",
             "t_tree_allreduce", "t_butterfly_allreduce",
             "t_ring_allreduce", "t_allreduce_best")


def _nets(name):
    r = getattr(ref, name)
    return cm.Network(r.name, r.alpha, r.beta), r


@pytest.mark.parametrize("name", NETS)
def test_paper_networks_equal(name):
    assert dataclasses.astuple(getattr(cm, name)) == \
        dataclasses.astuple(getattr(ref, name))


@pytest.mark.parametrize("fn", SCHEDULES)
@pytest.mark.parametrize("net", NETS)
def test_schedule_costs_equal(fn, net):
    mine, theirs = _nets(net)
    for n, p in itertools.product(SIZES, PS):
        if fn == "t_msg":
            assert cm.t_msg(n, mine) == ref.t_msg(n, theirs)
        else:
            assert getattr(cm, fn)(n, p, mine) == \
                getattr(ref, fn)(n, p, theirs), (fn, n, p)


@pytest.mark.parametrize("net", NETS)
def test_per_layer_and_packed_equal(net):
    mine, theirs = _nets(net)
    layers = [[], [4.0], [64.0, 4096.0, 1e6], [float(4 * 2 ** k)
                                              for k in range(20)]]
    for sizes, p in itertools.product(layers, PS):
        assert cm.t_per_layer(sizes, p, mine) == \
            ref.t_per_layer(sizes, p, theirs)
        assert cm.t_packed(sizes, p, mine) == ref.t_packed(sizes, p, theirs)
        for fn in ("t_ring_allreduce", "t_tree_allreduce"):
            assert cm.t_per_layer(sizes, p, mine, getattr(cm, fn)) == \
                ref.t_per_layer(sizes, p, theirs, getattr(ref, fn))
            assert cm.t_packed(sizes, p, mine, getattr(cm, fn)) == \
                ref.t_packed(sizes, p, theirs, getattr(ref, fn))


@pytest.mark.parametrize("name", ("KNL_7250", "K80_HALF"))
def test_paper_chips_equal(name):
    """The paper's 2017 nodes: the reference's rates and sizes (the
    port's names say they are the paper's)."""
    mine, theirs = getattr(cm, name), getattr(ref, name)
    assert dataclasses.astuple(mine)[1:] == dataclasses.astuple(theirs)[1:]
    assert "paper" in mine.name


def test_h100_from_its_data_sheet():
    """The card's rates are chip_smoke.PEAKS' "H100" row; no TPU chip is
    carried into the port."""
    import chip_smoke
    row = dict((k, v) for k, *v in chip_smoke.PEAKS)["H100"]
    assert (cm.H100_SXM.hbm_bandwidth, cm.H100_SXM.peak_flops) == \
        (row[0], row[2])
    assert cm.H100_SXM.hbm_bytes == 80 * 1024 ** 3
    assert cm.H100_SXM.link_bandwidth == 450e9
    assert not any(hasattr(cm, k) for k in ("TPU_V5E", "TPU_ICI",
                                             "TPU_DCI"))


def _chips():
    """The reference's chips, passed into the port's ``Chip``."""
    return [(cm.Chip(*dataclasses.astuple(getattr(ref, k))),
             getattr(ref, k)) for k in ("TPU_V5E", "KNL_7250", "K80_HALF")]


@pytest.mark.parametrize("chips", (1, 8, 256, 512))
def test_roofline_equal(chips):
    grid = ((0.0, 0.0, 0.0), (4.6e14, 5.8e12, 6.9e10), (1e18, 1e12, 3e14),
            (2.4e16, 1.0, 0.0))
    for (mine_chip, ref_chip), (f, b, c) in itertools.product(_chips(),
                                                             grid):
        a = cm.roofline(f, b, c, chips, mine_chip)
        r = ref.roofline(f, b, c, chips, ref_chip)
        assert (a.compute_s, a.memory_s, a.collective_s) == \
            (r.compute_s, r.memory_s, r.collective_s)
        assert (a.dominant, a.bound_s, a.serial_s) == \
            (r.dominant, r.bound_s, r.serial_s)


def test_roofline_defaults_to_the_card():
    t = cm.roofline(989e12, 3.35e12, 450e9, 1)
    assert (t.compute_s, t.memory_s, t.collective_s) == (1.0, 1.0, 1.0)


def test_model_flops_equal():
    for n, d in itertools.product((0, 1, 3_879_925_248, 2.36e11),
                                  (1, 4096, 1_048_576)):
        assert cm.model_flops_train(n, d) == ref.model_flops_train(n, d)
        assert cm.model_flops_infer(n, d) == ref.model_flops_infer(n, d)


def _pairs_by_loop(S, causal, window):
    total = 0
    for q in range(S):
        lo = max(0, q - window + 1) if window else 0
        hi = q + 1 if causal else S
        total += max(0, hi - lo)
    return total


def test_attention_pairs_closed_form():
    for S, causal, w in itertools.product(
            (1, 2, 5, 24, 77, 100, 150, 1024, 1025, 4096), (True, False),
            (0, 1, 8, 9, 48, 1024, 5000)):
        assert cm.attn_pairs(S, causal, w) == _pairs_by_loop(S, causal, w)


def test_work_formulas():
    """Each kernel's (bytes, operations) on a hand-counted shape."""
    # attention: B 1, S 4, H 2, KVH 1, D 8, Dv 4, causal: 10 pairs a head
    q, o, k, v, lse = 1 * 4 * 2 * 8, 1 * 4 * 2 * 4, 4 * 8, 4 * 4, 4 * 2 * 4
    assert cm.attention_fwd_work(1, 4, 2, 1, 8, 4, True, 0, 1) == \
        (q + k + v + o + lse, 2 * 20 * 12)
    assert cm.attention_bwd_work(1, 4, 2, 1, 8, 4, True, 0, 1) == \
        (2 * (q + k + v + o) + lse, 2 * 20 * (24 + 8))
    assert cm.ce_fwd_work(3, 5, 7, 2) == (30 + 70 + 24 + 48, 210.0)
    assert cm.ce_bwd_work(3, 5, 7, 2) == (200 + 48, 630.0)
    # SSD: B 1, H 2, S 8, P 3, N 4, L 4: 2 chunks of 10 pairs
    assert cm.ssd_fwd_work(1, 2, 8, 3, 4, 4) == (
        64 + 2 * 192 + 2 * 128, 2 * 20 * (4 + 6))
    assert cm.ssd_bwd_work(1, 2, 8, 3, 4, 4) == (
        128 + 3 * 192 + 4 * 128, 2 * 20 * (12 + 12))
    assert cm.elastic_update_work(2, 10, (4, 2, 4, 2, 4)) == (
        2 * 10 * 16 + 10 * 8, 170)
    assert cm.sync_easgd_work(10) == (480, 90)
    assert cm.sync_easgd_solo_work(10) == (320, 50)
    assert cm.sync_sgd_work(10) == (400, 50)
    assert cm.bound_ms(3.35e12, 1.0, 3.35e12, 1.0) == (1000.0, "bytes")
    assert cm.bound_ms(1.0, 2.0, 3.35e12, 1.0) == (2000.0, "operations")

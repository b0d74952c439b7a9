"""The port's exchange stack (``repro_torch.comm``, ``core.costmodel``)
against the reference's: the same rounds, the same bucket cuts, the same
prices.

Prices are compared with ``math.isclose(rel_tol=1e-12)``, not ``==``: two
sums of the same terms in another order can differ in the last bit (the
reference's own ``t_rounds`` and ``cost_from_rounds`` do, for tree at P=8).
"""
import math

import pytest

from repro.comm import rounds as ref_rounds
from repro.comm import schedules as ref_sched
from repro.core import costmodel as ref_cost
from repro_torch.comm import rounds, schedules
from repro_torch.core import costmodel

NETS = [("pcie", costmodel.PCIE3_X16, ref_cost.Network("PCIe3x16", 5e-6,
                                                       1 / 12e9)),
        ("wire", costmodel.PS_WIRE, ref_cost.PS_WIRE)]
N_BYTES = (8.0, 4096.0, 8 * 6_976_842.0)


def _flat(rs):
    return [[(m.src, m.dst, m.frac, m.chunk, m.chunks, m.op) for m in rnd]
            for rnd in rs]


def _spans(rs, n):
    return [[m.span(n) for m in rnd] for rnd in rs]


def test_port_net_is_the_ps_runtime_default():
    from repro.ps import runtime as ref_runtime
    ref = ref_runtime._DEFAULT_NET
    assert (costmodel.PCIE3_X16.alpha, costmodel.PCIE3_X16.beta) == \
        (ref.alpha, ref.beta)
    assert (costmodel.PS_WIRE.alpha, costmodel.PS_WIRE.beta) == \
        (ref_cost.PS_WIRE.alpha, ref_cost.PS_WIRE.beta)


def test_schedule_registry_names_match():
    assert schedules.names() == ref_sched.names()


@pytest.mark.parametrize("name", ["psum", "tree", "butterfly", "ring",
                                  "round_robin", "hierarchical"])
@pytest.mark.parametrize("p", [2, 3, 4, 8])
def test_rounds_match_reference(name, p):
    """Same src, dst, op, frac, chunk and span for every message; the
    power-of-two schedules refuse P=3 in both."""
    for _, net, ref_net in NETS:
        for n_bytes in N_BYTES:
            try:
                want = ref_sched.get(name).rounds(p, n_bytes, ref_net)
            except ValueError:
                with pytest.raises(ValueError):
                    schedules.get(name).rounds(p, n_bytes, net)
                continue
            got = schedules.get(name).rounds(p, n_bytes, net)
            assert _flat(got) == _flat(want)
            n_elem = 24 * p
            assert _spans(got, n_elem) == _spans(want, n_elem)


@pytest.mark.parametrize("hosts,slots", [(2, 4), (2, 3), (4, 2)])
def test_topology_rounds_match_reference(hosts, slots):
    topo = costmodel.Topology(hosts, slots, costmodel.PS_WIRE,
                              costmodel.Network("x", 1e-3, 4 / 9e6))
    ref_topo = ref_cost.Topology(hosts, slots, ref_cost.PS_WIRE,
                                 ref_cost.Network("x", 1e-3, 4 / 9e6))
    p = hosts * slots
    for name in ("hierarchical", "psum", "ring"):
        got = schedules.get(name).rounds(p, 8e6, topology=topo)
        want = ref_sched.get(name).rounds(p, 8e6, topology=ref_topo)
        assert _flat(got) == _flat(want), name
    assert math.isclose(rounds.t_rounds(got, 8e6, topology=topo),
                        ref_rounds.t_rounds(want, 8e6, topology=ref_topo),
                        rel_tol=1e-12)


@pytest.mark.parametrize("name", ["psum", "tree", "butterfly", "ring",
                                  "round_robin", "hierarchical"])
def test_costs_match_reference(name):
    for _, net, ref_net in NETS:
        for p in (1, 2, 4, 8, 16):
            for n_bytes in N_BYTES:
                got = schedules.get(name).cost(n_bytes, p, net)
                want = ref_sched.get(name).cost(n_bytes, p, ref_net)
                assert math.isclose(got, want, rel_tol=1e-12)
                rs = ref_sched.get(name).rounds(p, n_bytes, ref_net)
                assert math.isclose(
                    rounds.t_rounds(schedules.get(name).rounds(
                        p, n_bytes, net), n_bytes, net),
                    ref_rounds.t_rounds(rs, n_bytes, ref_net),
                    rel_tol=1e-12)


@pytest.mark.parametrize("label", [label for label, _, _ in NETS])
def test_choose_matches_reference(label):
    _, net, ref_net = next(x for x in NETS if x[0] == label)
    for p in (1, 2, 3, 4, 8, 16):
        for n_bytes in (8.0, 1e3, 1e5, 1e7, 1e9):
            assert schedules.choose(n_bytes, p, net) == \
                ref_sched.choose(n_bytes, p, ref_net)
    topo = costmodel.Topology(4, 4, costmodel.PS_WIRE,
                              costmodel.Network("x", 1e-3, 4 / 9e6))
    ref_topo = ref_cost.Topology(4, 4, ref_cost.PS_WIRE,
                                 ref_cost.Network("x", 1e-3, 4 / 9e6))
    for n_bytes in (8.0, 1e5, 1e7):
        assert schedules.choose(n_bytes, 16, topology=topo) == \
            ref_sched.choose(n_bytes, 16, topology=ref_topo)


def test_elastic_align_constant_matches_reference():
    assert rounds.ELASTIC_UPDATE_ALIGN == ref_rounds.ELASTIC_UPDATE_ALIGN


@pytest.mark.parametrize("sizes,n,target,align", [
    ([1024, 32, 128, 4], 1188, 32, None),
    ([1024, 32, 128, 4], 1188, 10**6, None),
    (None, 10, 4, None),
    ([100, 100, 100], 300, 100, 128),
])
def test_bucket_boundaries_match_reference(sizes, n, target, align):
    """The cases of tests/test_bucketing.py's boundary tests."""
    got = rounds.bucket_boundaries(sizes, n, target, align=align)
    assert got == ref_rounds.bucket_boundaries(sizes, n, target, align=align)


@pytest.mark.parametrize("sizes,n,bucket_bytes", [
    ([100, 100, 100], 300, 800),
    ([2**17 + 7, 2**17 - 3, 2**18], 2**19 + 9, 2**17 * 8 * 8),
    (None, 6_976_844, 4 << 20),
])
def test_default_bucket_boundaries_match_reference(sizes, n, bucket_bytes):
    got = rounds.default_bucket_boundaries(sizes, n, bucket_bytes)
    assert got == ref_rounds.default_bucket_boundaries(sizes, n,
                                                       bucket_bytes)


def test_alexnet_bucket_boundaries_match_reference():
    """The main path's cuts: AlexNet's layers in ravel order, 4 MiB."""
    from repro_torch.models import cnn
    sizes = [math.prod(s) for _, s in cnn.ravel_layout("alexnet")]
    padded = sum(sizes) + (-sum(sizes)) % 4
    got = rounds.default_bucket_boundaries(sizes, padded, 4 << 20)
    assert got == ref_rounds.default_bucket_boundaries(sizes, padded,
                                                       4 << 20)
    assert len(got) > 2


@pytest.mark.parametrize("p", [2, 3, 4])
def test_bucket_rounds_match_reference(p):
    n = 1000 + (-1000) % p
    bounds = rounds.bucket_boundaries(None, n, 130)
    for name in ("ring", "tree", "butterfly", "round_robin"):
        try:
            want_rs = ref_sched.get(name).rounds(p)
        except ValueError:
            continue
        got = rounds.bucket_rounds(schedules.get(name).rounds(p), n, bounds)
        want = ref_rounds.bucket_rounds(want_rs, n, bounds)
        assert [[[(m.src, m.dst, m.op, span) for m, span in rnd]
                 for rnd in plan] for plan in got] == \
            [[[(m.src, m.dst, m.op, span) for m, span in rnd]
              for rnd in plan] for plan in want]

"""Topology-aware scale-out in the port (``PSConfig.topology`` /
``link_profile``, per-link pacing, the measured-profile schedule choice,
the ``--topology HOSTSxSLOTS`` launchers), against the reference
(``repro.core.costmodel``, ``repro.comm``, ``repro.ps``, ``repro.net``).

 1. Every test of the reference's ``tests/test_topology.py``, run on the
    port: link classing, wire round trips, the emulated factory, the
    generalized hierarchical rounds, per-wid pricing, the chooser under
    two-level networks, the runtime's validation, heartbeat scaling,
    measured profiles, the tcp p2p byte oracle and the DES.
 2. Parity: the wire forms cross the packages both ways, and every ported
    pricing function (``t_rounds(wid=)``, ``t_rounds_buckets``,
    ``cost_from_rounds``, ``bytes_from_rounds``, ``framed_wire_bytes``,
    ``cost_s``, ``choose(topology= | profile=)``, ``hb_*_eff_s``, the tcp
    master's per-wid deadlines) equals the reference's by ``==`` over
    P ∈ {2, 4, 8, 16, 64} × schedules × topologies: the operation order
    is the same. The one ``isclose`` (rel 1e-12) is the port's own
    ``t_rounds`` against its ``cost_from_rounds``: two different sums,
    which disagree by one bit in the reference too (ROADMAP R2).
 3. Runs: a 2×4 thread run is bit for bit ``repro.ps.run_ps`` under the
    same topology, a 1-host topology run bit for bit the flat run, and a
    2×2 tcp p2p run moves exactly the registry's bytes per link and per
    link class (bit for bit the thread run).
"""
import dataclasses
import io
import math
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from repro import ps as ref_ps
from repro.comm import plan as ref_plan
from repro.comm import rounds as ref_rounds
from repro.comm import schedules as ref_schedules
from repro.core import costmodel as ref_costmodel
from repro.core.easgd import EASGDConfig as RefConfig
from repro.net import server as ref_server
from repro_torch.comm import plan, rounds, schedules
from repro_torch.core import costmodel
from repro_torch.core.easgd import EASGDConfig
from repro_torch.launch import cluster, train
from repro_torch.net import server
from repro_torch.net.peer import predicted_link_bytes
from repro_torch.ps import problems, runtime

ETA, RHO, MU = 0.05, 0.07, 0.9
CFG = EASGDConfig(eta=ETA, rho=RHO, mu=MU)
REF_CFG = RefConfig(eta=ETA, rho=RHO, mu=MU)
NB = 9504.0          # NUMPY_MLP: 1188 f64 weights on the wire
SIZES = [1024, 32, 128, 4]   # its layer sizes
PS = (2, 4, 8, 16, 64)


def _ref_topo(t):
    return ref_costmodel.Topology.from_wire(t.to_wire())


def _topologies(p):
    """The grid's fabrics at P = p: one host, and every multi-host split
    with the default, a milder and the unit cross multipliers, over the
    PS wire and over PCIe3x16."""
    out = [costmodel.Topology(1, p)]
    for hosts in (2, 4, 8):
        if p % hosts or hosts > p:
            continue
        for intra in (costmodel.PS_WIRE, costmodel.PCIE3_X16):
            out.append(costmodel.emulated_topology(hosts, p // hosts, intra))
        out.append(costmodel.emulated_topology(hosts, p // hosts,
                                               cross_alpha_x=5.0,
                                               cross_beta_x=2.0))
        out.append(costmodel.emulated_topology(hosts, p // hosts,
                                               cross_alpha_x=1.0,
                                               cross_beta_x=1.0))
    return out


def _runnable(name, p, topo):
    """The rounds of ``name`` at P = p under ``topo`` in both packages, or
    None where the schedule cannot run there (both must refuse)."""
    try:
        mine = schedules.get(name).rounds(p, NB, topology=topo)
    except ValueError:
        with pytest.raises(ValueError):
            ref_schedules.get(name).rounds(p, NB, topology=_ref_topo(topo))
        return None
    return mine, ref_schedules.get(name).rounds(p, NB,
                                                topology=_ref_topo(topo))


# ---------------------------------------------------------------------------
# (1) the model
# ---------------------------------------------------------------------------

def test_topology_link_classing():
    t = costmodel.emulated_topology(2, 4)
    assert t.p == 8 and t.hosts == 2 and t.slots == 4
    assert t.host_of(0) == t.host_of(3) == 0
    assert t.host_of(4) == t.host_of(7) == 1
    assert t.host_of(-1) == -1                   # the master is no host
    assert t.link(0, 3) is t.intra
    assert t.link(3, 4) is t.cross
    assert t.link(rounds.MASTER, 5) is t.cross   # master ↔ worker: slow
    assert not t.uniform
    assert t.cross.alpha == pytest.approx(20 * t.intra.alpha)
    assert t.cross.beta == pytest.approx(4 * t.intra.beta)


def test_one_host_topology_is_uniform():
    t = costmodel.emulated_topology(1, 8)
    assert t.uniform
    assert t.link(0, 7) is t.intra


def test_unit_multipliers_collapse_to_uniform():
    t = costmodel.emulated_topology(4, 2, cross_alpha_x=1.0,
                                    cross_beta_x=1.0)
    assert t.uniform and t.cross is t.intra


def test_emulated_topology_validates():
    with pytest.raises(ValueError):
        costmodel.emulated_topology(0, 8)
    with pytest.raises(ValueError):
        costmodel.emulated_topology(2, 0)


def test_topology_wire_roundtrip():
    t = costmodel.emulated_topology(2, 8)
    assert costmodel.Topology.from_wire(t.to_wire()) == t
    prof = costmodel.LinkProfile(topology=t, source="measured",
                                 detail={"alpha0_us": 12.5})
    back_p = costmodel.LinkProfile.from_wire(prof.to_wire())
    assert back_p.topology == t
    assert back_p.source == "measured"
    assert back_p.detail["alpha0_us"] == 12.5


@pytest.mark.parametrize("hosts,slots,ax,bx", [
    (2, 8, 20.0, 4.0), (4, 6, 5.0, 2.0), (1, 4, 20.0, 4.0),
    (2, 2, 1.0, 1.0)])
def test_wire_forms_cross_the_packages(hosts, slots, ax, bx):
    """The port's wire form is the reference's, both ways, field for
    field (a WELCOME from either master reads in either worker)."""
    mine = costmodel.emulated_topology(hosts, slots, cross_alpha_x=ax,
                                       cross_beta_x=bx)
    ref = ref_costmodel.emulated_topology(hosts, slots, cross_alpha_x=ax,
                                          cross_beta_x=bx)
    assert mine.to_wire() == ref.to_wire()
    assert ref_costmodel.Topology.from_wire(mine.to_wire()) == ref
    assert costmodel.Topology.from_wire(ref.to_wire()) == mine
    prof = costmodel.LinkProfile(mine, "measured:tcp", {"alpha0_s": 1e-4})
    ref_prof = ref_costmodel.LinkProfile.from_wire(prof.to_wire())
    assert ref_prof.topology == ref and ref_prof.detail == prof.detail
    assert costmodel.LinkProfile.from_wire(ref_prof.to_wire()) == prof


# ---------------------------------------------------------------------------
# (2) two-level costs and generalized hierarchical rounds
# ---------------------------------------------------------------------------

def test_hierarchical_group_from_topology():
    t = costmodel.emulated_topology(2, 8)
    assert rounds.topology_group(16, t) == 8
    assert rounds.topology_group(8, t) == rounds.inner_size(8)
    assert rounds.topology_group(16, None) == rounds.inner_size(16)


def test_hierarchical_rounds_non_pow2_p_pow2_groups():
    t = costmodel.emulated_topology(4, 6)
    rr = rounds.hierarchical_rounds(24, NB, topology=t)
    workers = {m.src for rnd in rr for m in rnd} | \
              {m.dst for rnd in rr for m in rnd}
    assert workers == set(range(24))
    with pytest.raises(ValueError, match="power-of-two"):
        rounds.hierarchical_rounds(24, NB,
                                   topology=costmodel.emulated_topology(3, 8))
    with pytest.raises(ValueError, match="tile"):
        rounds.hierarchical_rounds(8, NB, group=3)


def test_schedule_rounds_pow2_gate_lifted_only_with_topology():
    sched = schedules.get("hierarchical")
    t = costmodel.emulated_topology(4, 6)
    assert sched.rounds(24, NB, topology=t)
    with pytest.raises(ValueError):
        sched.rounds(24, NB)


def test_one_host_cost_topo_bitwise_equals_flat():
    t = costmodel.Topology(hosts=1, slots=8, intra=costmodel.PS_WIRE,
                           cross=costmodel.PS_WIRE)
    for name in schedules.names():
        sched = schedules.get(name)
        assert sched.cost_topo(NB, 8, t) == \
            sched.cost(NB, 8, costmodel.PS_WIRE), name


def test_t_rounds_uniform_equals_cost_from_rounds():
    """The reference's test, on the port, with ``isclose``: the per-link
    pricer and the closed per-round formula are two different float sums
    (tree at P = 8 differs by one bit in both packages, ROADMAP R2)."""
    net = costmodel.PS_WIRE
    for name in ("ring", "butterfly", "tree", "hierarchical"):
        sched = schedules.get(name)
        rr = sched.rounds(8, NB)
        assert math.isclose(rounds.t_rounds(rr, NB, net=net),
                            sched.cost_from_rounds(NB, 8, net),
                            rel_tol=1e-12), name


def test_t_rounds_per_wid_prices_own_links_only():
    t = costmodel.emulated_topology(2, 4)
    rr = rounds.hierarchical_rounds(8, NB, topology=t)
    full = rounds.t_rounds(rr, NB, topology=t)
    per_wid = [rounds.t_rounds(rr, NB, topology=t, wid=i) for i in range(8)]
    assert all(0 < p <= full for p in per_wid)
    assert max(per_wid) == pytest.approx(full)


def test_two_level_hierarchical_closed_form():
    t = costmodel.emulated_topology(2, 8)
    want = (costmodel.t_ring_allreduce(NB, 8, t.intra)
            + costmodel.t_butterfly_allreduce(NB, 2, t.cross))
    assert costmodel.t_hierarchical_two_level(NB, t) == pytest.approx(want)
    assert costmodel.t_hierarchical_two_level(NB, t) == \
        ref_costmodel.t_hierarchical_two_level(NB, _ref_topo(t))


# ---------------------------------------------------------------------------
# (2b) the pricing grid against the reference, by ==
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", PS)
def test_round_pricing_equals_reference(p):
    """``t_rounds`` (global and per wid), ``t_rounds_buckets`` (global and
    per wid), ``cost_topo``, ``cost_from_rounds`` and
    ``bytes_from_rounds`` of every schedule on every fabric of the grid,
    equal to the reference's."""
    padded = 1188 + (-1188) % p
    bounds = rounds.default_bucket_boundaries(SIZES, padded, 2048)
    assert bounds == ref_rounds.default_bucket_boundaries(SIZES, padded,
                                                          2048)
    assert len(bounds) > 2
    wids = sorted({0, 1, p // 2, p - 1})
    checked = 0
    for topo in _topologies(p):
        rt = _ref_topo(topo)
        for name in schedules.names():
            both = _runnable(name, p, topo)
            if both is None:
                continue
            mine, ref = both
            assert rounds.rounds_to_wire(mine) == \
                ref_rounds.rounds_to_wire(ref), name
            for wid in (None, *wids):
                assert rounds.t_rounds(mine, NB, topology=topo, wid=wid) == \
                    ref_rounds.t_rounds(ref, NB, topology=rt, wid=wid)
                assert rounds.t_rounds_buckets(
                    mine, padded, bounds, topology=topo, wid=wid) == \
                    ref_rounds.t_rounds_buckets(ref, padded, bounds,
                                                topology=rt, wid=wid)
            assert rounds.bytes_from_rounds(mine, NB) == \
                ref_rounds.bytes_from_rounds(ref, NB)
            assert schedules.get(name).cost_topo(NB, p, topo) == \
                ref_schedules.get(name).cost_topo(NB, p, rt)
            checked += 1
        for name in schedules.names():
            if schedules.get(name).pow2_only and p & (p - 1):
                continue
            for net, ref_net in ((costmodel.PS_WIRE, ref_costmodel.PS_WIRE),
                                 (topo.cross, rt.cross)):
                assert schedules.get(name).cost_from_rounds(NB, p, net) == \
                    ref_schedules.get(name).cost_from_rounds(NB, p, ref_net)
                assert schedules.get(name).bytes_from_rounds(NB, p, net) == \
                    ref_schedules.get(name).bytes_from_rounds(NB, p, ref_net)
                mine_flat = schedules.get(name).rounds(p, NB, net)
                assert math.isclose(
                    rounds.t_rounds(mine_flat, NB, net=net),
                    schedules.get(name).cost_from_rounds(NB, p, net),
                    rel_tol=1e-12), name
    assert checked >= len(_topologies(p)) * 3


@pytest.mark.parametrize("p", PS)
def test_choose_and_plan_pricing_equal_reference(p):
    """``choose`` over a topology and over a profile carrying it, and the
    plan's ``framed_wire_bytes`` / ``cost_s`` on a topology, at several
    buffer sizes, equal to the reference's."""
    for topo in _topologies(p):
        rt = _ref_topo(topo)
        prof = costmodel.LinkProfile(topo, "analytic")
        ref_prof = ref_costmodel.LinkProfile(rt, "analytic")
        for nb in (NB, 2.0**16, 2.0**22, 2.0**27):
            want = ref_schedules.choose(nb, p, topology=rt)
            assert schedules.choose(nb, p, topology=topo) == want
            assert schedules.choose(nb, p, profile=prof) == \
                ref_schedules.choose(nb, p, profile=ref_prof) == want
        for comp in ("none", "bf16", "sign_ef"):
            for name in ("ring", "psum", "hierarchical"):
                mine = plan.make_plan(name, comp, n_total=p, topology=topo)
                ref = ref_plan.make_plan(name, comp, n_total=p, topology=rt)
                assert mine.framed_wire_bytes(4099) == \
                    ref.framed_wire_bytes(4099)
                for n_el in (1188, 1 << 20):
                    assert mine.cost_s(n_el, costmodel.PS_WIRE) == \
                        ref.cost_s(n_el, ref_costmodel.PS_WIRE), (name, comp)


# ---------------------------------------------------------------------------
# (3) the chooser under two-level networks
# ---------------------------------------------------------------------------

def test_choose_hierarchical_iff_cross_dominates_and_multihost():
    for p, want_hier in ((8, False), (16, True), (32, True), (64, True)):
        topo = costmodel.emulated_topology(max(p // 8, 1), 8)
        got = schedules.choose(NB, p, topology=topo)
        assert (got == "hierarchical") == want_hier, (p, got)
    for p in (16, 32, 64):
        topo = costmodel.emulated_topology(p // 8, 8, cross_alpha_x=1.0,
                                           cross_beta_x=1.0)
        got = schedules.choose(NB, p, topology=topo)
        assert got == schedules.choose(NB, p, costmodel.PS_WIRE), (p, got)


def test_choose_two_level_beats_flat_on_cross_bytes():
    topo = costmodel.emulated_topology(2, 8)
    hier = schedules.get("hierarchical").cost_topo(NB, 16, topo)
    ring = schedules.get("ring").cost_topo(NB, 16, topo)
    butterfly = schedules.get("butterfly").cost_topo(NB, 16, topo)
    assert hier < min(ring, butterfly)


def test_choose_non_pow2_p_with_pow2_groups():
    topo = costmodel.emulated_topology(4, 6)
    assert schedules.choose(NB, 24, topology=topo) == "hierarchical"


def test_choose_profile_carries_topology():
    topo = costmodel.emulated_topology(2, 8)
    prof = costmodel.LinkProfile(topology=topo, source="analytic")
    assert schedules.choose(NB, 16, profile=prof) == \
        schedules.choose(NB, 16, topology=topo)


# ---------------------------------------------------------------------------
# (4) the runtime
# ---------------------------------------------------------------------------

def _thread_cfg(mod, P, topology, schedule="hierarchical", iters=24, **kw):
    return mod.PSConfig(algorithm="sync_easgd", n_workers=P,
                        total_iters=iters, transport="thread",
                        schedule=schedule, eval_every_iters=10**9,
                        deterministic=True, topology=topology, **kw)


def test_homogeneous_topology_thread_run_bitwise_equal():
    """A 1-host topology paces on its intra class and leaves the math
    alone: center and workers bit for bit the flat run's."""
    base = runtime.run_ps(problems.NUMPY_MLP, CFG,
                          _thread_cfg(runtime, 4, None, schedule="ring"),
                          device="cpu")
    topo = runtime.run_ps(problems.NUMPY_MLP, CFG,
                          _thread_cfg(runtime, 4,
                                      costmodel.emulated_topology(1, 4),
                                      schedule="ring"), device="cpu")
    assert torch.equal(base.center, topo.center)
    assert torch.equal(base.workers, topo.workers)


@pytest.mark.parametrize("algo", ["sync_easgd", "sync_sgd"])
def test_two_host_thread_run_bitwise_reference(algo):
    """Under ``emulated_topology(2, 4)`` (hierarchical, groups by host,
    per-link pacing) the port's thread run is bit for bit the reference's
    under the same topology."""
    mine = costmodel.emulated_topology(2, 4)
    ref = ref_ps.run_ps(ref_ps.NUMPY_MLP, REF_CFG, dataclasses.replace(
        _thread_cfg(ref_ps, 8, _ref_topo(mine)), algorithm=algo))
    port = runtime.run_ps(problems.NUMPY_MLP, CFG, dataclasses.replace(
        _thread_cfg(runtime, 8, mine), algorithm=algo), device="cpu")
    assert port.schedule == ref.schedule == "hierarchical"
    np.testing.assert_array_equal(port.center.numpy(), ref.center)
    np.testing.assert_array_equal(port.workers.numpy(), ref.workers)
    for key in ("sync_rounds", "messages", "wire_bytes"):
        assert port.counters[key] == ref.counters[key], key


def test_thread_topology_auto_resolves_hierarchical():
    topo = costmodel.emulated_topology(2, 8)
    res = runtime.run_ps(problems.NUMPY_MLP, CFG,
                         _thread_cfg(runtime, 16, topo, schedule="auto",
                                     iters=16), device="cpu")
    assert res.schedule == "hierarchical"
    assert res.total_iters == 16


def test_psconfig_topology_asserts():
    """The reference's five conditions, with its messages; the port
    raises ValueError where the reference asserts."""
    topo = costmodel.emulated_topology(2, 4)
    with pytest.raises(ValueError, match="REPLACES emulate_net"):
        _thread_cfg(runtime, 8, topo, emulate_net=costmodel.PS_WIRE)
    with pytest.raises(ValueError, match="n_workers"):
        _thread_cfg(runtime, 4, topo)
    with pytest.raises(ValueError, match="sync family"):
        dataclasses.replace(_thread_cfg(runtime, 8, None),
                            algorithm="async_easgd", topology=topo)
    with pytest.raises(ValueError, match="elastic"):
        runtime.PSConfig(algorithm="sync_easgd", n_workers=8,
                         transport="tcp", schedule="ring", sync_plane="p2p",
                         topology=topo, elastic=True)
    with pytest.raises(ValueError, match="link_profile"):
        _thread_cfg(runtime, 8, None,
                    link_profile=costmodel.LinkProfile(topology=topo))
    with pytest.raises(ValueError, match="thread and tcp"):
        runtime.PSConfig(algorithm="sync_easgd", n_workers=8,
                         transport="process", topology=topo)
    # the reference refuses the same configurations
    rt = _ref_topo(topo)
    with pytest.raises(AssertionError, match="REPLACES emulate_net"):
        _thread_cfg(ref_ps, 8, rt, emulate_net=ref_costmodel.PS_WIRE)
    with pytest.raises(AssertionError, match="thread and tcp"):
        ref_ps.PSConfig(algorithm="sync_easgd", n_workers=8,
                        transport="process", topology=rt)


def test_resolved_schedule_order_profile_topology_net():
    """"auto": a passed profile, then ``link_profile``, then the
    topology, then the flat net — as the reference resolves."""
    topo = costmodel.emulated_topology(2, 8)
    flat_prof = costmodel.LinkProfile(costmodel.Topology(1, 16))
    cfg = _thread_cfg(runtime, 16, topo, schedule="auto")
    ref = _thread_cfg(ref_ps, 16, _ref_topo(topo), schedule="auto")
    ref_flat = ref_costmodel.LinkProfile(ref_costmodel.Topology(1, 16))
    assert cfg.resolved_schedule(NB) == ref.resolved_schedule(NB) == \
        "hierarchical"
    assert cfg.resolved_schedule(NB, profile=flat_prof) == \
        ref.resolved_schedule(NB, profile=ref_flat) != "hierarchical"
    with_prof = dataclasses.replace(cfg, link_profile=flat_prof)
    assert with_prof.resolved_schedule(NB) == \
        cfg.resolved_schedule(NB, profile=flat_prof)
    flat = _thread_cfg(runtime, 16, None, schedule="auto")
    assert flat.resolved_schedule(NB) == _thread_cfg(
        ref_ps, 16, None, schedule="auto").resolved_schedule(NB)


def test_hb_scaling_pins():
    for P in (2, 4, 8, 16):
        cfg = _thread_cfg(runtime, P, None, schedule="ring")
        assert cfg.hb_interval_eff_s() == cfg.hb_interval_s
    cfg64 = _thread_cfg(runtime, 64, None, schedule="ring")
    assert cfg64.hb_interval_eff_s() == pytest.approx(
        cfg64.hb_interval_s * 4.0)
    assert cfg64.hb_timeout_eff_s() >= 12.0 * cfg64.hb_interval_eff_s()
    assert cfg64.hb_timeout_eff_s(16) >= cfg64.hb_timeout_s


@pytest.mark.parametrize("p", PS)
def test_hb_scaling_equals_reference(p):
    for interval, timeout in ((2.0, 60.0), (0.5, 3.0), (0.1, 1.0)):
        mine = runtime.PSConfig(algorithm="sync_easgd", n_workers=p,
                                hb_interval_s=interval, hb_timeout_s=timeout)
        ref = ref_ps.PSConfig(algorithm="sync_easgd", n_workers=p,
                              hb_interval_s=interval, hb_timeout_s=timeout)
        for q in (None, 2, 16, 64):
            assert mine.hb_interval_eff_s(q) == ref.hb_interval_eff_s(q)
            assert mine.hb_timeout_eff_s(q) == ref.hb_timeout_eff_s(q)


def test_accept_backlog_scales_with_p():
    assert server.accept_backlog(4) == 16
    assert server.accept_backlog(8) == 16
    assert server.accept_backlog(16) == 24
    assert server.accept_backlog(64) == 72


@pytest.mark.parametrize("topo_args,schedule,bucket_bytes", [
    ((2, 2), "hierarchical", 0), ((2, 2), "ring", 2048),
    ((2, 4), "hierarchical", 2048), ((4, 2), "butterfly", 0)])
def test_tcp_master_pacing_equals_reference(topo_args, schedule,
                                            bucket_bytes):
    """The tcp master's pacing under a topology, without a socket: each
    wid's exchange deadline and per-bucket deadlines in WELCOME, the
    master-link message pair and the global exchange time equal the
    reference master's."""
    topo = costmodel.emulated_topology(*topo_args)
    kw = dict(algorithm="sync_easgd", n_workers=topo.p, transport="tcp",
              schedule=schedule, sync_plane="p2p", bucket_bytes=bucket_bytes,
              eval_every_iters=10**9)
    mine = server.MasterServer(problems.NUMPY_MLP, CFG, runtime.PSConfig(
        topology=topo, **kw), device="cpu")
    ref = ref_server.MasterServer(ref_ps.NUMPY_MLP, REF_CFG, ref_ps.PSConfig(
        topology=_ref_topo(topo), **kw))
    assert mine._t_sync_wire() == ref._t_sync_wire()
    for wid in range(topo.p):
        assert mine._t_msg_pair(wid) == ref._t_msg_pair(wid)
        a, b = mine._welcome_payload(wid), ref._welcome_payload(wid)
        for key in ("t_wire_s", "t_wire_bucket_s", "topology",
                    "hb_interval_s", "rounds"):
            assert a[key] == b[key], (wid, key)
        assert a["t_wire_s"] == mine._t_sync_wire(wid) <= \
            mine._t_sync_wire()


def test_measured_link_profile_thread():
    cfg = _thread_cfg(runtime, 8, costmodel.emulated_topology(2, 4))
    prof = runtime.measured_link_profile(cfg, device="cpu")
    assert prof.source.startswith("measured")
    t = prof.topology
    assert t.intra.alpha >= cfg.topology.intra.alpha
    assert t.intra.beta >= cfg.topology.intra.beta
    assert t.cross.alpha >= cfg.topology.cross.alpha
    assert not t.uniform
    assert schedules.choose(NB, 8, profile=prof) in schedules.names()
    probed = runtime.measured_link_profile(
        cfg, counters={"link_alpha_s": {0: 3e-4, 1: 1e-4, 2: 2e-4}},
        base=(5e-5, 1e-9))
    assert probed.detail["alpha0_s"] == 2e-4
    assert probed.topology.intra.alpha == cfg.topology.intra.alpha + 2e-4
    assert probed.topology.cross.beta == cfg.topology.cross.beta + 1e-9
    with pytest.raises(ValueError, match="topology"):
        runtime.measured_link_profile(_thread_cfg(runtime, 8, None))


def test_calibrate_builds_profile_only_under_topology():
    cal_flat = runtime.calibrate(
        problems.NUMPY_MLP, _thread_cfg(runtime, 4, None, schedule="ring"),
        samples=2, device="cpu")
    assert cal_flat.profile is None
    cal_topo = runtime.calibrate(
        problems.NUMPY_MLP,
        _thread_cfg(runtime, 8, costmodel.emulated_topology(2, 4)),
        samples=2, device="cpu")
    assert cal_topo.profile is not None
    assert cal_topo.profile.topology.hosts == 2
    sim = cal_topo.sim_config("sync_easgd", "hierarchical")
    assert sim.topology == cal_topo.profile.topology
    assert sim.net == cal_topo.profile.topology.intra


def test_tcp_p2p_topology_bytes_match_two_level_registry():
    """A 2-host emulated tcp p2p run: every peer link moves exactly the
    registry's prediction, the intra / cross totals are the host_of
    partition of it, each worker labels its links by class, and the math
    is bit for bit the thread run under the same topology."""
    topo = costmodel.emulated_topology(2, 2)
    iters = 8
    cfg = runtime.PSConfig(algorithm="sync_easgd", n_workers=4,
                           total_iters=iters, transport="tcp",
                           schedule="hierarchical", sync_plane="p2p",
                           deterministic=True, eval_every_iters=10**9,
                           topology=topo)
    res = runtime.run_ps(problems.NUMPY_MLP, CFG, cfg, device="cpu")
    n = res.center.numel()
    padded = n + (-n) % 4
    exchanges = iters // 4
    per = predicted_link_bytes(
        schedules.get("hierarchical").rounds(4, n * 8, topology=topo),
        padded)
    want = {f"{i}-{j}": exchanges * b for (i, j), b in per.items()}
    assert res.counters["peer_link_bytes"] == want
    intra = sum(b for (i, j), b in per.items()
                if topo.host_of(i) == topo.host_of(j)) * exchanges
    cross = sum(b for (i, j), b in per.items()
                if topo.host_of(i) != topo.host_of(j)) * exchanges
    assert res.counters["intra_host_bytes"] == intra
    assert res.counters["cross_host_bytes"] == cross
    assert intra > 0 and cross > 0
    thread = runtime.run_ps(problems.NUMPY_MLP, CFG, dataclasses.replace(
        cfg, transport="thread", sync_plane="master"), device="cpu")
    assert torch.equal(res.center, thread.center)
    assert torch.equal(res.workers, thread.workers)


def test_des_weak_scaling_sees_topology():
    from repro_torch.core.des import weak_scaling_efficiency
    net = costmodel.PS_WIRE
    topo = costmodel.emulated_topology(2, 8)
    kw = dict(t_compute=5e-3, weight_bytes=NB, net=net, overlap=False,
              schedule="hierarchical")
    flat = weak_scaling_efficiency(16, **kw)
    two = weak_scaling_efficiency(16, topology=topo, **kw)
    assert two < flat
    uni = weak_scaling_efficiency(16, topology=costmodel.Topology(
        1, 16, net, net), **kw)
    assert uni == flat


# ---------------------------------------------------------------------------
# (5) the launchers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv,msg", [
    (["--workers", "4", "--topology", "2by2"], "HOSTSxSLOTS"),
    (["--workers", "4", "--topology", "2x4"], "does not tile"),
    (["--workers", "4", "--topology", "2x2", "--transport", "process"],
     "thread or tcp"),
    (["--workers", "4", "--topology", "2x2", "--algorithm", "async_easgd"],
     "sync-family"),
    (["--workers", "4", "--topology", "2x2", "--elastic"], "elastic"),
])
def test_cluster_launcher_topology_errors(argv, msg, capsys):
    with pytest.raises(SystemExit) as exc:
        cluster.main(argv + ["--device", "cpu"])
    assert exc.value.code == 2
    assert msg in capsys.readouterr().err


@pytest.mark.parametrize("argv,msg", [
    (["--topology", "2by2"], "HOSTSxSLOTS"),
    (["--topology", "2x4"], "does not tile"),
    (["--topology", "2x2", "--transport", "process"], "thread or tcp"),
    (["--topology", "2x2", "--algorithm", "async_easgd"], "sync_*"),
])
def test_train_launcher_topology_errors(argv, msg):
    with pytest.raises(SystemExit, match=msg.replace("*", r"\*")):
        train.main(["--mode", "ps", "--ps-workers", "4", "--device", "cpu",
                    *argv])


def test_launchers_run_a_topology_on_the_thread_plane():
    """``--topology 2x4`` through both launchers (thread plane): the
    global emulated wire is off, the schedule resolves per link class
    (``auto`` from the calibrated profile in ``launch.train``)."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        res = cluster.main(["--workers", "8", "--transport", "thread",
                            "--topology", "2x4", "--schedule",
                            "hierarchical", "--iters", "16", "--device",
                            "cpu"])
        out = train.main(["--mode", "ps", "--algorithm", "all-sync",
                          "--ps-workers", "8", "--ps-iters", "16",
                          "--topology", "2x4", "--schedule", "auto",
                          "--device", "cpu"])
    assert res[0].schedule == "hierarchical"
    assert [r.schedule for r in out] == ["hierarchical"] * 2
    lines = [ln for ln in buf.getvalue().splitlines() if "ratio=" in ln]
    assert len(lines) == 2 and all("[thread/hierarchical@cpu]" in ln
                                   for ln in lines)

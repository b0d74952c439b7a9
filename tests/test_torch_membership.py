"""Elastic membership and chaos injection in the port (``repro_torch.ft``,
the RECONFIGURE plane of ``repro_torch.net``), against the reference
(``repro.ft``, ``repro.comm.rounds``, ``repro.net``, ``repro.ps``).

 1. Units, exact: the membership state machine on one script, the dense
    rank map and ``remap_rounds``, the flat-row pod ops (bit for bit on
    f64 rows) and the packed-state ones on ``core.elastic.ElasticState``
    against the reference's ``ElasticState``, ``ChaosSpec`` across the two
    packages' environments, the dial's refuse window, and the RECONFIGURE
    frames byte for byte in both directions.
 2. The failure matrix on real worker interpreters (``--device cpu``):
    SIGKILL shrinks a p2p run to epoch 1 (the survivors at the epoch's P),
    SIGTERM is a clean ``preempted`` departure, the master plane absorbs a
    kill (async: quota intact; sync: the plan rebuilt for P′), a respawn
    started on the reconfigure event rejoins at epoch 2, and a chaos
    dial-refuse window is absorbed bit for bit (port == port == the
    reference).
 3. Elastic off keeps a kill fatal; ``topology`` still raises beside
    ``elastic``.
"""
import dataclasses
import signal
import socket
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ps as ref_ps
from repro.comm import rounds as ref_rounds
from repro.comm import schedules as ref_schedules
from repro.core import elastic as ref_elastic
from repro.core.easgd import EASGDConfig as RefConfig
from repro.ft import chaos as ref_chaos
from repro.ft import elastic_scale as ref_scale
from repro.ft import membership as ref_membership
from repro.net import wire as ref_wire
from repro_torch.comm import rounds as comm_rounds
from repro_torch.comm import schedules as comm_schedules
from repro_torch.core import costmodel, elastic
from repro_torch.core.easgd import EASGDConfig
from repro_torch.ft import chaos as ft_chaos
from repro_torch.ft import elastic_scale, membership
from repro_torch.net import server as net_server
from repro_torch.net import wire
from repro_torch.ps import problems, runtime

ETA, RHO, MU = 0.05, 0.07, 0.9
CFG = EASGDConfig(eta=ETA, rho=RHO, mu=MU)
REF_CFG = RefConfig(eta=ETA, rho=RHO, mu=MU)
NET = costmodel.Network("tiny-emu", 5e-3, 1e-9)
TOL = dict(rtol=1e-6, atol=1e-7)     # tests/test_torch_elastic.py's


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# (1a) the state machine, the rank map and the rounds
# ---------------------------------------------------------------------------

def _script(mod):
    """One membership script, its snapshot after each step."""
    t = mod.MembershipTable(4)
    out = [t.snapshot()]
    for w in range(4):
        t.mark_ready(w)
    t.mark_suspect(3)
    out.append(t.snapshot())
    t.mark_dead(1, "socket drop")
    t.mark_left(2, "preempted")
    t.mark_suspect(2)                    # a LEFT worker stays LEFT
    out += [t.snapshot(), t.survivors(), t.advance_epoch()]
    t.mark_rejoined(1)
    out += [t.snapshot(), t.joiners(), t.members[1].epoch,
            t.advance_epoch(), t.snapshot(), t.survivors(),
            [t.state(w) for w in range(4)], [t.is_lost(w) for w in range(4)]]
    return out


def test_membership_table_transitions_match_reference():
    assert _script(membership) == _script(ref_membership)
    assert membership.STATES == ref_membership.STATES


@pytest.mark.parametrize("survivors", [[0, 1, 3], [2, 5, 6, 9], [4]])
def test_dense_rank_map_and_remap_rounds_match_reference(survivors):
    assert (membership.dense_rank_map(survivors)
            == ref_membership.dense_rank_map(survivors))
    p = len(survivors)
    for name in ("ring", "tree", "butterfly", "round_robin"):
        if name in ("butterfly", "tree") and p & (p - 1):
            continue
        mine = comm_rounds.remap_rounds(
            comm_schedules.get(name).rounds(p, 8000.0),
            membership.dense_rank_map(survivors))
        ref = ref_rounds.remap_rounds(
            ref_schedules.get(name).rounds(p, 8000.0),
            ref_membership.dense_rank_map(survivors))
        assert (comm_rounds.rounds_to_wire(mine)
                == ref_rounds.rounds_to_wire(ref)), name
        ends = {m.src for rnd in mine for m in rnd} | {
            m.dst for rnd in mine for m in rnd}
        assert ends <= set(survivors) | {comm_rounds.MASTER}


# ---------------------------------------------------------------------------
# (1b) elastic scaling: flat rows and packed state
# ---------------------------------------------------------------------------

def test_flat_row_pod_ops_bitwise_with_reference():
    rng = np.random.RandomState(0)
    w, v, center = rng.randn(4, 37), rng.randn(4, 37), rng.randn(37)
    tw, tv, tc = (torch.from_numpy(a.copy()) for a in (w, v, center))
    for k in range(4):
        got = elastic_scale.pod_leave_rows(tw, tv, k)
        want = ref_scale.pod_leave_rows(w, v, k)
        for g, r in zip(got, want):
            assert g.dtype == torch.float64
            np.testing.assert_array_equal(g.numpy(), r)
    got = elastic_scale.pod_join_rows(tw, tv, tc)
    want = ref_scale.pod_join_rows(w, v, center)
    for g, r in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), r)
    with pytest.raises(ValueError):
        elastic_scale.pod_leave_rows(tw, tv, 4)


def _ref_state(rng, pods, ef):
    def tree(lead=()):
        return {"w": jnp.asarray(rng.randn(*lead, 3, 4), jnp.float32),
                "b": (jnp.asarray(rng.randn(*lead, 4), jnp.float32),
                      jnp.asarray(rng.randn(*lead, 2, 2), jnp.float32))}
    return ref_elastic.ElasticState(
        jnp.asarray(3, jnp.int32), tree((pods,)), tree((pods,)), tree(),
        tree((pods,)) if ef else None)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_same(port, ref):
    want = elastic.state_from_jax(_np(ref), device="cpu")
    for name in ("params", "momentum", "center", "ef_error"):
        a, b = getattr(port, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.shape == b.shape and a.dtype == b.dtype, name
            np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=name,
                                       **TOL)


@pytest.mark.parametrize("ef", [False, True])
def test_packed_pod_ops_match_reference_state(ef):
    rng = np.random.RandomState(1)
    ref = _ref_state(rng, 3, ef)
    port = elastic.state_from_jax(_np(ref), device="cpu")
    _assert_same(elastic_scale.pod_leave(port, 1),
                 ref_scale.pod_leave(ref, 1))
    _assert_same(elastic_scale.pod_join(port), ref_scale.pod_join(ref))
    for p in (1, 3, 5):
        _assert_same(elastic_scale.rescale_pods(port, p),
                     ref_scale.rescale_pods(ref, p))


# ---------------------------------------------------------------------------
# (1c) chaos and the dial
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    {"wid": 2, "kill_at_iter": 10, "signal": "kill"},
    {"wid": 1, "kill_at_iter": 20, "signal": "term", "dial_refuse_s": 0.5},
    {"wid": 0}])
def test_chaos_spec_crosses_the_two_packages(spec):
    mine, ref = ft_chaos.ChaosSpec(**spec), ref_chaos.ChaosSpec(**spec)
    assert ft_chaos.ENV_VAR == ref_chaos.ENV_VAR
    assert mine.to_env() == ref.to_env()
    back = ref_chaos.ChaosSpec.from_env({ref_chaos.ENV_VAR: mine.to_env()})
    assert back == ref
    fwd = ft_chaos.ChaosSpec.from_env({ft_chaos.ENV_VAR: ref.to_env()})
    assert fwd == mine
    assert ft_chaos.ChaosSpec.from_config(spec) == mine
    assert ft_chaos.ChaosSpec.from_config(None) is None
    assert ft_chaos.ChaosSpec.from_env({}) is None


def test_chaos_validation_and_clock():
    with pytest.raises(ValueError, match="segv"):
        ft_chaos.ChaosSpec(wid=0, signal="segv")
    with pytest.raises(ValueError):
        ft_chaos.ChaosSpec(wid=0, dial_refuse_s=-1.0)
    clock = ft_chaos.clock_from_env({})
    clock.maybe_fire(0, 10**9)           # no spec: nothing fires
    assert not clock.refuse_dial(0)
    armed = ft_chaos.ChaosClock(ft_chaos.ChaosSpec(wid=1, dial_refuse_s=0.1))
    assert armed.refuse_dial(1) and not armed.refuse_dial(0)
    time.sleep(0.15)
    assert not armed.refuse_dial(1)
    armed.maybe_fire(1, 50)              # kill_at_iter −1: never fires


def test_dial_refuse_fn_window_is_retried():
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen()
    attempts = [0]

    def refuse():
        attempts[0] += 1
        return attempts[0] <= 3

    try:
        conn = wire.dial_with_backoff("127.0.0.1", srv.getsockname()[1],
                                      deadline_s=10.0, seed=2,
                                      refuse_fn=refuse)
        conn.close()
    finally:
        srv.close()
    assert attempts[0] == 4
    port = _free_port()                  # nothing listens: refused to the end
    with pytest.raises(wire.DialError, match="chaos|refused"):
        wire.dial_with_backoff("127.0.0.1", port, deadline_s=0.3, seed=0,
                               refuse_fn=lambda: True)


# ---------------------------------------------------------------------------
# (1d) RECONFIGURE frames, byte for byte
# ---------------------------------------------------------------------------

def _reconf_payloads():
    roster = [0, 1, 3]
    rounds = comm_rounds.remap_rounds(
        comm_schedules.get("ring").rounds(3, 8 * 1001.0),
        membership.dense_rank_map(roster))
    phase1 = {"phase": 1, "epoch": 1, "p": 3, "survivors": roster,
              "rounds": comm_rounds.rounds_to_wire(rounds), "padded": 1002,
              "peers": {str(w): ["127.0.0.1", 40000 + w] for w in roster},
              "bucket_bounds": [0, 500, 1002], "n_rounds": 60,
              "sync_wid": 0, "reporter": 0, "t_wire_s": 0.015,
              "t_wire_bucket_s": [0.01, 0.005]}
    phase2 = {"phase": 2, "epoch": 1, "resume_round": 20,
              "eval_rounds": [29, 59], "upload_state": True}
    ack = {"epoch": 1, "round": 20, "step": 20}
    return [phase1, phase2, ack]


def _emit(mod, payloads) -> bytes:
    a, b = socket.socketpair()
    link = mod.Link(a)
    for i, pay in enumerate(payloads):
        link.send_json(mod.RECONFIGURE, pay, wid=i)
    link.send_array(mod.CENTER, np.arange(7.0), wid=-2, raw=True)
    a.close()
    out = b""
    while chunk := b.recv(1 << 16):
        out += chunk
    b.close()
    return out


def test_reconfigure_frames_are_the_reference_bytes():
    assert wire.RECONFIGURE == ref_wire.RECONFIGURE == 16
    pays = _reconf_payloads()
    assert _emit(wire, pays) == _emit(ref_wire, pays)


@pytest.mark.parametrize("direction", ["port_to_ref", "ref_to_port"])
def test_reconfigure_frames_decode_with_the_other_module(direction):
    src, dst = ((wire, ref_wire) if direction == "port_to_ref"
                else (ref_wire, wire))
    a, b = socket.socketpair()
    tx, rx = src.Link(a), dst.Link(b)
    pays = _reconf_payloads()
    for i, pay in enumerate(pays):
        tx.send_json(src.RECONFIGURE, pay, wid=i)
    tx.send_array(src.CENTER, np.arange(7.0), wid=-2, raw=True)
    for i, pay in enumerate(pays):
        frame = rx.recv_header()
        assert (frame.ftype, frame.wid) == (dst.RECONFIGURE, i)
        assert rx.recv_json(frame) == pay
    frame = rx.recv_header()
    assert (frame.ftype, frame.wid) == (dst.CENTER, -2)
    np.testing.assert_array_equal(rx.recv_array(frame), np.arange(7.0))
    a.close(), b.close()


# ---------------------------------------------------------------------------
# (1e) config
# ---------------------------------------------------------------------------

def test_config_gates():
    with pytest.raises(ValueError, match="elastic"):
        runtime.PSConfig(algorithm="sync_easgd", transport="thread",
                         elastic=True)
    with pytest.raises(ValueError, match="chaos"):
        runtime.PSConfig(algorithm="sync_easgd", transport="process",
                         chaos={"wid": 0})
    with pytest.raises(ValueError, match="segv"):
        runtime.PSConfig(algorithm="sync_easgd", transport="tcp",
                         chaos={"wid": 0, "signal": "segv"})
    cfg = runtime.PSConfig(algorithm="sync_easgd", transport="tcp",
                           elastic=True, chaos={"wid": 1})
    assert cfg.elastic and cfg.chaos == {"wid": 1}


def test_topology_still_raises_naming_the_next_slice():
    """Topology is ported; beside elastic membership it still raises, as
    in the reference (the two are not composed)."""
    with pytest.raises(ValueError, match="elastic"):
        runtime.PSConfig(algorithm="sync_easgd", transport="tcp",
                         elastic=True, topology=costmodel.Topology(2, 2))
    assert runtime.PSConfig(algorithm="sync_easgd", transport="tcp",
                            topology=costmodel.Topology(2, 2)).topology


# ---------------------------------------------------------------------------
# (2) the failure matrix — real worker interpreters, deterministic chaos
# ---------------------------------------------------------------------------

def _ecfg(algo="sync_easgd", P=4, iters=240, **kw):
    kw.setdefault("eval_every_iters", 10**9)
    kw.setdefault("schedule", "ring")
    kw.setdefault("sync_plane", "p2p")
    return runtime.PSConfig(algorithm=algo, n_workers=P, total_iters=iters,
                            transport="tcp", elastic=True, **kw)


def _run(cfg):
    return runtime.run_ps(problems.NUMPY_MLP, CFG, cfg, device="cpu",
                          join_timeout_s=120.0)


def _ref_run(algo="sync_easgd", P=4, iters=240, **kw):
    """The reference's run of the same elastic tcp configuration."""
    kw.setdefault("eval_every_iters", 10**9)
    kw.setdefault("schedule", "ring")
    kw.setdefault("sync_plane", "p2p")
    return ref_ps.run_ps(ref_ps.NUMPY_MLP, REF_CFG, ref_ps.PSConfig(
        algorithm=algo, n_workers=P, total_iters=iters, transport="tcp",
        elastic=True, **kw))


def _events(res):
    return [(e["kind"], e["wid"], e.get("detail", ""))
            for e in res.health["events"]]


def _resume_rounds(res) -> list:
    """The agreed resume round of each p2p reconfiguration, in order."""
    return [int(e["detail"].split("resume_round=")[1])
            for e in res.health["events"] if e["kind"] == "reconfigure"]


def _draws(res, members) -> dict:
    """Per member, the gradients it drew in epoch 0."""
    return {w: res.counters["worker_epochs"][w][0]["grads"] for w in members}


def _assert_bitwise_with_reference(res, chaos, members, **kw):
    """The p2p plane is deterministic once the resume round is agreed and
    the members' data streams are known, so the elastic run — rollback,
    the epoch's P′, padding and rounds — is a function of them.

    The resume round may vary by one: a peer still finishing the exchange
    of the lost worker's last round when phase 1 aborts it (or the dead
    socket's reset cuts it short) acks one round fewer. So the oracle is
    the reference's elastic run with that worker SIGKILLed at the port's
    resume round r: the same survivors resume from the same snapshot.

    A rollback restores weights and steps, not the problem's sampler (the
    numpy MLP draws each batch from a per-worker RandomState, in both
    packages). In the kill run every survivor has started round r, so has
    drawn r + 1 gradients; a survivor that saw phase 1 before it started
    round r drew one fewer, and its later batches differ. The center and
    workers must match bit for bit whenever the draws are the kill run's;
    otherwise the run is not that function's input, and only its epoch
    arithmetic is held (by the caller)."""
    resume = _resume_rounds(res)
    assert len(resume) == 1
    assert abs(resume[0] - chaos["kill_at_iter"]) <= 1
    ref = _ref_run(chaos=dict(chaos, kill_at_iter=resume[0],
                              signal="kill"), **kw)
    assert _resume_rounds(ref) == resume
    assert _events(res)[1:] == _events(ref)[1:]      # the reconfigure
    assert res.health["epoch"] == ref.health["epoch"] == 1
    assert res.total_iters == ref.total_iters
    draws = _draws(res, members)
    assert all(resume[0] <= d <= resume[0] + 2 for d in draws.values())
    if set(draws.values()) == {resume[0] + 1}:
        np.testing.assert_array_equal(res.center.numpy(), ref.center)
        np.testing.assert_array_equal(res.workers.numpy(), ref.workers)


def _assert_epoch_chain(res, n_rounds: int, members) -> None:
    """Every member's epoch log chains: each epoch starts at the master's
    resume round for it, the rounds kept (up to the next resume round)
    add up to the run's round count, and every round kept made one update
    launch a live bucket (the interrupted round's launches are rolled
    back)."""
    resumes = dict(zip(range(1, 1 + len(_resume_rounds(res))),
                       _resume_rounds(res)))
    for wid in members:
        log = res.counters["worker_epochs"][wid]
        kept = 0
        for i, e in enumerate(log):
            if e["epoch"] > 0:
                assert e["start"] == resumes[e["epoch"]], (wid, e)
            last = i == len(log) - 1
            stop = e["end"] if last else e["resume_next"]
            assert e["rounds"] == e["end"] - e["start"]
            assert 0 <= e["rounds"] - (stop - e["start"]) <= 1
            extra = e["updates"] - e["rounds"] * e["live_buckets"]
            assert extra == 0 if last else 0 <= extra < e["live_buckets"]
            kept += stop - e["start"]
        assert log[0]["start"] + kept == n_rounds, (wid, log)


def test_elastic_sigkill_shrinks_p2p_run():
    """SIGKILL mid-run: the p2p plane freezes, reconfigures onto the three
    survivors at P = 3 and completes. The run equals the reference's
    elastic run bit for bit (the reconfigure event, center and workers),
    and its loss is near a clean P = 3 run's (the reference's bound).
    Every survivor's BYE logs epoch 0 at P = 4 and epoch 1 at P = 3 from
    the agreed resume round."""
    chaos = {"wid": 2, "kill_at_iter": 20, "signal": "kill"}
    res = _run(_ecfg(chaos=chaos))
    _assert_bitwise_with_reference(res, chaos, [0, 1, 3])
    kinds = [e["kind"] for e in res.health["events"]]
    assert "worker_dead" in kinds and "reconfigure" in kinds
    assert res.health["epoch"] >= 1
    members = res.health["membership"]["members"]
    assert members[2] == "dead" and members[0] == "active"
    assert np.isfinite(res.final_metric)
    epochs = res.counters["worker_epochs"]
    assert sorted(epochs) == [0, 1, 3]
    for wid, log in epochs.items():
        assert [(e["epoch"], e["p"]) for e in log][:2] == [(0, 4), (1, 3)]
        assert log[1]["start"] == log[0]["resume_next"]
        assert log[-1]["end"] == 60          # 240 / 4 rounds, all run
    _assert_epoch_chain(res, 60, [0, 1, 3])
    assert res.total_iters == 4 * _resume_rounds(res)[0] + 3 * (
        60 - _resume_rounds(res)[0])
    clean = runtime.run_ps(problems.NUMPY_MLP, CFG, runtime.PSConfig(
        algorithm="sync_easgd", n_workers=3, total_iters=180,
        transport="tcp", schedule="ring", sync_plane="p2p",
        eval_every_iters=10**9), device="cpu")
    assert abs(res.final_metric - clean.final_metric) < 0.35


def test_elastic_sigkill_bucketed_sync_sgd_bitwise_with_reference():
    """Sync SGD with 1 KiB buckets, wid 1 killed: the shrunk epoch's
    padding and bucket boundaries change with P′ = 3, the velocity rolls
    back with the center, and the run is the reference's bit for bit."""
    chaos = {"wid": 1, "kill_at_iter": 15, "signal": "kill"}
    res = _run(_ecfg(algo="sync_sgd", bucket_bytes=1024, chaos=chaos))
    _assert_bitwise_with_reference(res, chaos, [0, 2, 3], algo="sync_sgd",
                                   bucket_bytes=1024)
    assert res.counters["n_buckets"] > 1
    _assert_epoch_chain(res, 60, [0, 2, 3])


def test_elastic_sigterm_is_clean_departure():
    """SIGTERM: the watchdog turns it into a mid-run BYE — LEFT with
    ``preempted``, not DEAD — and the run still completes. The worker
    leaves after round 20 (the flag is polled at the next round
    boundary), so the survivors resume at round 21, or at 20 if one of
    them was still in round 20's exchange when phase 1 aborted it: bit
    for bit the reference's run with wid 1 killed at that round when the
    survivors drew its gradients. (The reference's SIGTERM run varies the
    same way: a survivor that sees phase 1 before it starts round 21
    draws one batch fewer.)"""
    chaos = {"wid": 1, "kill_at_iter": 20, "signal": "term"}
    res = _run(_ecfg(chaos=chaos))
    _assert_bitwise_with_reference(res, chaos, [0, 2, 3])
    evs = {e["kind"]: e for e in res.health["events"]}
    assert "worker_left" in evs and evs["worker_left"]["wid"] == 1
    assert evs["worker_left"]["detail"] == "preempted"
    assert "reconfigure" in evs
    assert res.health["membership"]["members"][1] == "left"
    assert np.isfinite(res.final_metric)
    _assert_epoch_chain(res, 60, [0, 2, 3])


def test_elastic_master_plane_async_absorbs_kill():
    """The centralized async plane: the dead worker's slot is dropped and
    the survivors absorb the remaining iterations by arrival."""
    res = _run(_ecfg(algo="async_easgd", P=3, iters=120, sync_plane="master",
                     chaos={"wid": 1, "kill_at_iter": 10, "signal": "kill"}))
    assert "worker_dead" in [e["kind"] for e in res.health["events"]]
    assert res.health["membership"]["members"][1] == "dead"
    assert res.total_iters == 120
    assert np.isfinite(res.final_metric)


@pytest.mark.parametrize("algo", ["sync_easgd", "sync_sgd"])
def test_elastic_master_plane_sync_rebuilds_plan(algo):
    """The centralized sync pair: the roster shrinks to P′ = 2, the
    master's rounds, padding and mailbox are rebuilt for it (a
    'centralized' reconfigure at epoch 1) and the run completes. The
    rosters the master served account for every iteration: rounds at
    P = 3, then at P = 2 (one update per live worker, or one a round)."""
    res = _run(_ecfg(algo=algo, P=3, iters=120, sync_plane="master",
                     chaos={"wid": 2, "kill_at_iter": 8, "signal": "kill"}))
    recon = [e for e in res.health["events"] if e["kind"] == "reconfigure"]
    assert len(recon) == 1 and "p=2" in recon[0]["detail"]
    assert "(centralized)" in recon[0]["detail"]
    assert res.health["epoch"] == 1
    assert res.total_iters >= 120
    assert np.isfinite(res.final_metric)
    assert bool(torch.isfinite(res.center).all())
    rosters = res.counters["sync_rosters"]
    assert {p for p, _, _ in rosters} == {2, 3}
    assert sum(p * r for p, _, r in rosters) == res.total_iters
    for p, updates, _ in rosters:
        assert (updates <= p if algo == "sync_easgd" else updates == 1)


@pytest.mark.parametrize("algo", ["sync_easgd", "sync_sgd"])
def test_elastic_respawn_rejoins_next_epoch(tmp_path, algo):
    """The whole lifecycle: SIGKILL at epoch 0 → the survivors reconfigure
    to epoch 1 at P = 3 → a respawn of wid 2 (a standby interpreter,
    released by ``Respawner`` when the reconfigure event reaches the JSONL
    stream, which names the master's port) rejoins → epoch 2 at P = 4,
    every member active, the rejoiner exits 0. Each member's epochs chain
    through the master's resume rounds. Under Sync SGD the relayed state
    is [center|velocity]: every replica, the rejoiner's too, ends on the
    center bit for bit."""
    jsonl = tmp_path / "elastic.jsonl"
    cfg = _ecfg(algo=algo, iters=600, emulate_net=NET,
                telemetry_jsonl=str(jsonl),
                chaos={"wid": 2, "kill_at_iter": 10, "signal": "kill"})
    with net_server.Respawner(jsonl, 2, "cpu", timeout_s=60.0,
                              standby=True) as spare:
        res = _run(cfg)
    code, out = spare.finish(timeout_s=60.0)
    assert spare.spawned, "the reconfigure event never reached the JSONL"
    assert code == 0, out
    kinds = [e["kind"] for e in res.health["events"]]
    assert kinds.count("reconfigure") == 2       # shrink, then regrow
    assert "worker_rejoined" in kinds
    assert res.health["epoch"] == 2
    assert res.health["membership"]["members"] \
        == {0: "active", 1: "active", 2: "active", 3: "active"}
    assert np.isfinite(res.final_metric)
    log = res.counters["worker_epochs"][2]       # the rejoiner's own
    assert [(e["epoch"], e["p"]) for e in log] == [(2, 4)]
    assert log[0]["end"] == 150
    assert [e["p"] for e in res.counters["worker_epochs"][0]] == [4, 3, 4]
    _assert_epoch_chain(res, 150, [0, 1, 2, 3])
    r1, r2 = _resume_rounds(res)
    assert res.total_iters == 4 * r1 + 3 * (r2 - r1) + 4 * (150 - r2)
    if algo == "sync_sgd":
        for i in range(4):
            assert torch.equal(res.workers[i], res.center), i


def test_chaos_dial_refuse_absorbed_bitwise():
    """A refused HELLO dial window is retried away by the backoff: the
    deterministic run equals the port's run without it and the
    reference's, bit for bit."""
    def port(**kw):
        return runtime.run_ps(problems.NUMPY_MLP, CFG, runtime.PSConfig(
            algorithm="sync_easgd", n_workers=2, total_iters=40,
            transport="tcp", schedule="round_robin", deterministic=True,
            eval_every_iters=10**9, **kw), device="cpu")
    a = port()
    b = port(chaos={"wid": 1, "dial_refuse_s": 0.4})
    ref = ref_ps.run_ps(ref_ps.NUMPY_MLP, REF_CFG, ref_ps.PSConfig(
        algorithm="sync_easgd", n_workers=2, total_iters=40,
        transport="tcp", schedule="round_robin", deterministic=True,
        eval_every_iters=10**9))
    assert torch.equal(a.center, b.center)
    assert torch.equal(a.workers, b.workers)
    np.testing.assert_array_equal(b.center.numpy(), ref.center)
    np.testing.assert_array_equal(b.workers.numpy(), ref.workers)


# ---------------------------------------------------------------------------
# (3) elastic off keeps failures fatal
# ---------------------------------------------------------------------------

def test_kill_without_elastic_stays_fatal(monkeypatch):
    """The run fails naming a worker, as the reference's test asks: which
    one the master hears of first is a race (the killed worker's dropped
    socket or the survivor's ConnectionResetError). The kill itself
    landed on wid 1: its interpreter ended by SIGKILL."""
    spawned = []
    real = net_server.spawn_local_workers

    def spawn(*args, **kw):
        spawned.extend(real(*args, **kw))
        return spawned
    monkeypatch.setattr(net_server, "spawn_local_workers", spawn)
    cfg = dataclasses.replace(
        _ecfg(P=2, iters=200, chaos={"wid": 1, "kill_at_iter": 10,
                                     "signal": "kill"}), elastic=False)
    with pytest.raises(RuntimeError, match=r"worker \d+"):
        _run(cfg)
    assert len(spawned) == 2
    assert spawned[1].wait(timeout=30) == -signal.SIGKILL

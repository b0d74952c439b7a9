"""The port's live telemetry plane (``repro_torch.obs.live``,
``launch.monitor``, ``obs.regress``, the STATS frame, ``link_slow``)
against the reference (``repro.obs.live``, ``repro.launch.monitor``,
``repro.obs.regress``, ``repro.net.wire``, ``repro.ps``).

 1. Units, exact: ``Ring``, ``TimeSeries`` and ``sparkline`` on the same
    pushes; ``HealthDetector.observe`` on the same rate and staleness
    sequences; ``LiveMonitor`` on the same heartbeats, samples and
    lifecycle events (one fixed clock for both) gives the same
    ``health()``, ``snapshot()``, rendering and JSONL bytes; the STATS
    request and reply frames byte for byte in both directions;
    ``regress`` gives the same flattening and verdicts on the repo's
    ``BENCH_*.json`` and ``benchmarks/baselines/``.
 2. Runs (tcp workers are ``--device cpu`` interpreters): ``link_slow``
    changes the clock, not the math (port tcp == port thread == the
    reference's thread run, bit for bit); a slowed link is detected and
    named, a uniform run stays quiet; telemetry off attaches nothing and
    the thread and process transports get aggregate gauges with their
    JSONL; ``launch.monitor`` reads a live port run over STATS and renders
    the port's and the reference's JSONL; SIGTERM is a clean departure;
    the cluster launcher reports ``# health``.
"""
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import ps as ref_ps
from repro.core.easgd import EASGDConfig as RefConfig
from repro.launch import monitor as ref_monitor
from repro.net import wire as ref_wire
from repro.obs import live as ref_live
from repro.obs import metrics as ref_metrics
from repro.obs import regress as ref_regress
from repro_torch.core import costmodel
from repro_torch.core.easgd import EASGDConfig
from repro_torch.ft.watchdog import Watchdog
from repro_torch.launch import cluster
from repro_torch.launch import monitor
from repro_torch.net import server as net_server
from repro_torch.net import wire
from repro_torch.obs import live, metrics, regress
from repro_torch.ps import problems, runtime

ETA, RHO, MU = 0.05, 0.07, 0.9
CFG = EASGDConfig(eta=ETA, rho=RHO, mu=MU)
REF_CFG = RefConfig(eta=ETA, rho=RHO, mu=MU)
NET = costmodel.Network("tiny-emu", 5e-3, 1e-9)
REPO = Path(__file__).resolve().parents[1]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# (1a) the store
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("capacity,pushes", [(4, 6), (8, 3), (5, 5)])
def test_ring_matches_reference(capacity, pushes):
    mine, ref = live.Ring(capacity), ref_live.Ring(capacity)
    assert mine.last() == ref.last() is None
    rng = np.random.RandomState(capacity)
    for i in range(pushes):
        t, v = float(i), float(rng.randn())
        mine.push(t, v)
        ref.push(t, v)
        assert mine.last() == ref.last()
    assert mine.n == ref.n
    for a, b in zip(mine.values(), ref.values()):
        np.testing.assert_array_equal(a, b)


def test_timeseries_and_sparkline_match_reference():
    mine, ref = live.TimeSeries(capacity=4), ref_live.TimeSeries(capacity=4)
    rng = np.random.RandomState(3)
    for i in range(9):
        v = float(rng.randn())
        mine.record(i % 3, "rate_ips", v, 0.5 * i)
        ref.record(i % 3, "rate_ips", v, 0.5 * i)
        mine.record(-1, "iters", i, 0.5 * i)
        ref.record(-1, "iters", i, 0.5 * i)
    for store in (mine, ref):
        store.record(0, "note", "not-a-number", 1.0)   # dropped
    assert mine.wids() == ref.wids()
    assert mine.metrics(0) == ref.metrics(0)
    assert mine.last(1, "rate_ips") == ref.last(1, "rate_ips")
    assert mine.last(0, "nope") is ref.last(0, "nope") is None
    assert mine.tail(k=2) == ref.tail(k=2)
    for vals in ([0, 1, 2, 3], [], [5, 5], list(range(100)),
                 rng.randn(30).tolist()):
        assert live.sparkline(vals) == ref_live.sparkline(vals)
        assert live.sparkline(vals, 7) == ref_live.sparkline(vals, 7)


@pytest.mark.parametrize("mask", [[1, 1, 1, 1], [1, 0, 1, 0], [0, 0, 0, 0]])
def test_straggler_policy_and_masked_mean_match_reference(mask):
    from repro.ft import straggler as ref_straggler
    from repro_torch.ft import straggler
    rng = np.random.RandomState(sum(mask))
    delays = rng.rand(4) + np.array([0, 0, 0, 5.0])
    for factor, quorum in ((1.5, 0.5), (2.0, 0.75), (1.01, 1.0)):
        mine = straggler.BoundedStaleness(4, factor, quorum)
        ref = ref_straggler.BoundedStaleness(4, factor, quorum)
        np.testing.assert_array_equal(mine.participation(0, delays),
                                      ref.participation(0, delays))
    np.testing.assert_array_equal(
        straggler.StragglerPolicy(4).participation(0, delays),
        ref_straggler.StragglerPolicy(4).participation(0, delays))
    w = rng.randn(4, 9).astype(np.float32)
    c = rng.randn(9).astype(np.float32)
    got = straggler.masked_center_mean(torch.from_numpy(w),
                                       torch.from_numpy(c), mask)
    want = np.asarray(ref_straggler.masked_center_mean(w, c, mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# (1b) the detector and the monitor
# ---------------------------------------------------------------------------

def _sequences(seed, n_workers, steps):
    """Rate and staleness sequences with a straggler that comes and goes,
    a silent worker and build-time zeros."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(steps):
        rates = {w: float(10 + rng.randn()) for w in range(n_workers)}
        if 5 <= i < 15:
            rates[n_workers - 1] = 1.5
        if i < 2:
            rates[0] = 0.0 if i == 0 else None
        stale = {w: float(abs(rng.randn()) * 0.2) for w in range(n_workers)}
        if 20 <= i < 26:
            stale[1] = 7.5
        out.append((float(i), rates, stale))
    return out


@pytest.mark.parametrize("n_workers,factor,strikes", [
    (3, 2.0, 2), (4, 1.5, 1), (5, 3.0, 3)])
def test_health_detector_matches_reference(n_workers, factor, strikes):
    mine = live.HealthDetector(n_workers, deadline_factor=factor,
                               stale_after_s=6.0, strikes=strikes)
    ref = ref_live.HealthDetector(n_workers, deadline_factor=factor,
                                  stale_after_s=6.0, strikes=strikes)
    seen = []
    for i, (t, rates, stale) in enumerate(_sequences(n_workers, n_workers,
                                                     30)):
        if i == 22:                      # an elastic epoch change
            mine.set_n_workers(n_workers)
            ref.set_n_workers(n_workers)
        a, b = mine.observe(t, rates, stale), ref.observe(t, rates, stale)
        assert a == b, (i, a, b)
        assert mine.flagged == ref.flagged
        seen += a
    kinds = {e["kind"] for e in seen}
    assert {"straggler", "recovered", "hb_stale"} <= kinds, kinds


def _feed(mod, reg_mod, path):
    """One scripted live plane: heartbeats, samples, lifecycle events and
    a membership change, on a fixed clock. Returns the monitor's reads."""
    reg = reg_mod.Registry()
    mon = mod.LiveMonitor(3, hb_interval_s=0.1, jsonl_path=path,
                          counters=reg, meta={"algorithm": "unit",
                                              "transport": "tcp"})
    clock = iter(np.arange(0.0, 100.0, 0.25))
    mon._now = lambda: float(next(clock))
    mon.ingest_hb(0, {"iters": 10, "rate_ips": 10.0, "exposed_s": 0.01})
    mon.ingest_hb(1, {"iters": 10, "rate_ips": 10.0})
    mon.ingest_hb(2, {"iters": 1, "rate_ips": 1.0, "note": "x"})
    for k in range(3):
        mon.sample(staleness={0: 0.0, 1: 0.1, 2: 0.2 * k},
                   gauges={"iters": 21 + k, "wire_bytes": 1000 * k,
                           "label": "skip"})
    mon.mark_worker_event(2, "worker_dead", "socket drop")
    mon.set_membership([0, 1])
    mon.mark_worker_event(-1, "reconfigure", "epoch 1: p=2")
    mon.ingest_hb(0, {"iters": 20, "rate_ips": 9.0})
    mon.sample(staleness={0: 0.0, 1: 0.0}, gauges={"iters": 40})
    out = (mon.health(), mon.snapshot(k=4), mod.render(mon.snapshot()),
           reg.counter("health_events").value)
    mon.close()
    return out


def test_live_monitor_matches_reference(tmp_path):
    a = _feed(live, metrics, str(tmp_path / "port.jsonl"))
    b = _feed(ref_live, ref_metrics, str(tmp_path / "ref.jsonl"))
    assert a == b
    health, snap, text, n_events = a
    kinds = [e["kind"] for e in health["events"]]
    assert "straggler" in kinds and "worker_dead" in kinds
    assert n_events == len(health["events"])
    assert "rate history" in text
    assert ((tmp_path / "port.jsonl").read_bytes()
            == (tmp_path / "ref.jsonl").read_bytes())
    assert live.AGG_WID == ref_live.AGG_WID == -1


def test_stats_frames_are_the_reference_bytes(tmp_path):
    """The STATS request (``{"token", "k"}``) and reply (one snapshot)
    through either module's Link are the same bytes, and decode with the
    other's."""
    _, snap, _, _ = _feed(live, metrics, str(tmp_path / "a.jsonl"))
    snap = json.loads(json.dumps(snap))          # as the wire carries it
    frames = [({"token": "repro-net", "k": 8}, 0), (snap, 0)]

    def emit(mod):
        a, b = socket.socketpair()
        link = mod.Link(a)
        for pay, wid in frames:
            link.send_json(mod.STATS, pay, wid=wid)
        link.send_json(mod.ERROR, {"msg": "bad token"})
        a.close()
        out = b""
        while chunk := b.recv(1 << 16):
            out += chunk
        b.close()
        return out

    assert wire.STATS == ref_wire.STATS == 15
    assert emit(wire) == emit(ref_wire)
    for src, dst in ((wire, ref_wire), (ref_wire, wire)):
        a, b = socket.socketpair()
        tx, rx = src.Link(a), dst.Link(b)
        for pay, _ in frames:
            tx.send_json(src.STATS, pay)
        for pay, _ in frames:
            frame = rx.recv_header()
            assert frame.ftype == dst.STATS
            assert rx.recv_json(frame) == pay
        a.close(), b.close()


# ---------------------------------------------------------------------------
# (1c) the regression gate
# ---------------------------------------------------------------------------

def _bench_files():
    return sorted(REPO.glob("BENCH_*.json")) + sorted(
        (REPO / "benchmarks" / "baselines").glob("BENCH_*.json"))


def test_regress_matches_reference_on_the_repos_bench_files(tmp_path):
    files = _bench_files()
    assert len(files) >= 8
    for path in files:
        rec = json.loads(path.read_text())
        flat = regress.flatten_metrics(rec)
        assert flat == ref_regress.flatten_metrics(rec), path.name
        # the same verdicts on every metric moved up and down 2x
        for scale in (0.5, 2.0, 1.1):
            cur = {k: v * scale for k, v in flat.items()}
            assert (regress.compare(flat, cur)
                    == ref_regress.compare(flat, cur)), (path.name, scale)
            assert (regress.compare(flat, cur, tol=0.05,
                                    metric_filter="s")
                    == ref_regress.compare(flat, cur, tol=0.05,
                                           metric_filter="s"))
    base = REPO / "benchmarks" / "baselines" / "BENCH_p2p_overlap_smoke.json"
    drop = json.loads(base.read_text())
    drop = {k: (v / 2 if isinstance(v, float) else v)
            for k, v in drop.items()}
    cur = tmp_path / "cur.json"
    cur.write_text(json.dumps(drop))
    for argv in ([str(base), str(base)], [str(base), str(cur)],
                 [str(base), str(cur), "--warn-only"],
                 [str(base), str(cur), "--metrics", "iters_per_sec"]):
        assert regress.main(argv) == ref_regress.main(argv), argv


# ---------------------------------------------------------------------------
# (2) runs
# ---------------------------------------------------------------------------

def test_link_slow_changes_clock_not_math():
    """Deterministic admission: the port's tcp run with one link paced 3x
    slower equals the port's thread run and the reference's thread run,
    bit for bit."""
    def cfg(mod, transport, **kw):
        return mod.PSConfig(algorithm="async_easgd", n_workers=3,
                            total_iters=36, transport=transport,
                            schedule="round_robin", deterministic=True,
                            eval_every_iters=10**9, **kw)
    slow = runtime.run_ps(problems.NUMPY_MLP, CFG, cfg(
        runtime, "tcp", emulate_net=NET, link_slow=(1.0, 1.0, 3.0)),
        device="cpu")
    thread = runtime.run_ps(problems.NUMPY_MLP, CFG, cfg(runtime, "thread"),
                            device="cpu")
    ref = ref_ps.run_ps(ref_ps.NUMPY_MLP, REF_CFG, cfg(ref_ps, "thread"))
    assert torch.equal(slow.center, thread.center)
    assert torch.equal(slow.workers, thread.workers)
    np.testing.assert_array_equal(slow.center.numpy(), ref.center)
    np.testing.assert_array_equal(slow.workers.numpy(), ref.workers)
    assert slow.total_time_s > 12 * 2 * 3 * 5e-3   # wid 2's pacing was paid


def _live_cfg(link_slow, iters=240, **kw):
    # hogwild: each worker's reply deadline overlaps the others', so a
    # per-link pacing stretch is a real per-worker rate divergence
    return runtime.PSConfig(algorithm="hogwild_easgd", n_workers=3,
                            total_iters=iters, transport="tcp",
                            schedule="ring", eval_every_iters=10**9,
                            emulate_net=NET, link_slow=link_slow,
                            hb_interval_s=0.2, **kw)


def test_tcp_straggler_detected_and_named():
    res = runtime.run_ps(problems.NUMPY_MLP, CFG,
                         _live_cfg((1.0, 1.0, 8.0), telemetry=True),
                         device="cpu")
    stragglers = [e for e in res.health["events"]
                  if e["kind"] == "straggler"]
    assert stragglers, res.health["events"]
    assert all(e["wid"] == 2 for e in stragglers)
    # strikes = 2 at heartbeat-period sampling: the reference's bound
    assert stragglers[0]["t"] <= 6 * 0.2 + 0.1, stragglers[0]
    assert stragglers[0]["rate_ips"] < stragglers[0]["median_rate_ips"]
    assert res.counters["health_events"] == len(res.health["events"])
    assert set(res.health["workers"]) == {0, 1, 2}


def test_tcp_uniform_run_stays_quiet():
    res = runtime.run_ps(problems.NUMPY_MLP, CFG,
                         _live_cfg(None, iters=120, telemetry=True),
                         device="cpu")
    bad = [e for e in res.health["events"]
           if e["kind"] in ("straggler", "hb_stale")]
    assert bad == [], bad
    assert res.counters["health_events"] == 0
    assert set(res.health["workers"]) == {0, 1, 2}


def test_telemetry_off_is_the_default_and_attaches_nothing():
    cfg = runtime.PSConfig(algorithm="async_easgd", n_workers=2,
                           total_iters=20, transport="thread",
                           eval_every_iters=10**9)
    assert not cfg.telemetry_on
    res = runtime.run_ps(problems.NUMPY_MLP, CFG, cfg, device="cpu")
    assert res.health is None
    assert "health_events" not in res.counters


@pytest.mark.parametrize("transport", ["thread", "process"])
def test_shared_memory_transports_get_aggregate_telemetry(tmp_path,
                                                          transport):
    path = str(tmp_path / f"{transport}.jsonl")
    cfg = runtime.PSConfig(algorithm="async_easgd", n_workers=2,
                           total_iters=200, transport=transport,
                           eval_every_iters=10**9, telemetry_jsonl=path,
                           telemetry_interval_s=0.01)
    res = runtime.run_ps(problems.NUMPY_MLP, CFG, cfg, device="cpu")
    assert res.health["n_samples"] >= 1
    assert res.health["events"] == []
    assert res.counters["health_events"] == 0
    lines = [json.loads(x) for x in open(path)]
    assert lines[0]["meta"] == {"algorithm": "async_easgd",
                                "transport": transport}
    assert lines[-1]["gauges"]["iters"] == 200
    assert all(isinstance(v, (int, float))
               for v in lines[-1]["gauges"].values())


def test_link_slow_validation():
    with pytest.raises(ValueError, match="tcp"):
        runtime.PSConfig(algorithm="async_easgd", transport="thread",
                         n_workers=2, link_slow=(1.0, 2.0))
    with pytest.raises(ValueError, match="emulate"):
        runtime.PSConfig(algorithm="async_easgd", transport="tcp",
                         n_workers=2, link_slow=(1.0, 2.0))
    with pytest.raises(ValueError, match="one factor per worker"):
        runtime.PSConfig(algorithm="async_easgd", transport="tcp",
                         n_workers=3, emulate_net=NET, link_slow=(1.0, 2.0))
    with pytest.raises(ValueError):
        runtime.PSConfig(algorithm="async_easgd", transport="tcp",
                         n_workers=2, emulate_net=NET, link_slow=(1.0, 0.5))
    with pytest.raises(ValueError, match="straggler_factor"):
        runtime.PSConfig(algorithm="async_easgd", straggler_factor=1.0)


def test_monitor_reads_and_renders_a_live_port_run(tmp_path, capsys):
    port = _free_port()
    jsonl = str(tmp_path / "telem.jsonl")
    cfg = _live_cfg((1.0, 1.0, 8.0), telemetry=True, telemetry_jsonl=jsonl,
                    tcp_port=port)
    snaps, token_errs, cli = [], [], []

    def _poll():
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            try:
                snap = monitor.fetch_stats("127.0.0.1", port, k=8)
            except OSError:
                time.sleep(0.1)          # master still in rendezvous
                continue
            snaps.append(snap)
            if snap.get("n_samples", 0) >= 3:
                try:
                    monitor.fetch_stats("127.0.0.1", port, token="wrong")
                    token_errs.append(None)
                except RuntimeError as exc:
                    token_errs.append(exc)
                cli.append(monitor.main(["--connect", f"127.0.0.1:{port}",
                                         "--k", "8"]))
                return
            time.sleep(0.2)

    th = threading.Thread(target=_poll, daemon=True)
    th.start()
    res = runtime.run_ps(problems.NUMPY_MLP, CFG, cfg, device="cpu")
    th.join(timeout=30)
    assert not th.is_alive()
    assert res.total_iters == 240
    assert snaps, "the monitor never fetched a STATS snapshot mid-run"
    assert cli == [0]
    snap = snaps[-1]
    assert snap["meta"]["algorithm"] == "hogwild_easgd"
    assert snap["meta"]["transport"] == "tcp"
    assert {"0", "1", "2"} <= set(snap["workers"])
    out = live.render(snap)
    assert "rate history" in out
    for w in (0, 1, 2):
        assert f"\n   {w} " in out, out
    assert token_errs and isinstance(token_errs[0], RuntimeError)
    lines = [json.loads(x) for x in open(jsonl)]
    assert lines[0]["meta"]["algorithm"] == "hogwild_easgd"
    assert len(lines) > 1
    offline = monitor.snap_from_jsonl(jsonl)
    assert offline == ref_monitor.snap_from_jsonl(jsonl)
    assert "straggler" in live.render(offline)
    assert monitor.main(["--from-jsonl", jsonl]) == 0
    assert "run:" in capsys.readouterr().out


def test_monitor_renders_the_references_jsonl(tmp_path, capsys):
    path = str(tmp_path / "ref.jsonl")
    _feed(ref_live, ref_metrics, path)
    assert monitor.snap_from_jsonl(path) == ref_monitor.snap_from_jsonl(path)
    assert monitor.main(["--from-jsonl", path]) == 0
    mine = capsys.readouterr().out
    assert ref_monitor.main(["--from-jsonl", path]) == 0
    assert mine == capsys.readouterr().out


def test_sigterm_mid_run_is_a_clean_named_departure(tmp_path):
    port = _free_port()
    hb_file = str(tmp_path / "w1.hb")
    env = net_server.worker_env()
    cfg = runtime.PSConfig(algorithm="async_easgd", n_workers=2,
                           total_iters=4000, transport="tcp",
                           schedule="ring", eval_every_iters=10**9,
                           emulate_net=NET, tcp_port=port,
                           spawn_workers=False, telemetry=True,
                           hb_interval_s=0.2)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.net.worker",
         "--connect", f"127.0.0.1:{port}", "--wid", str(w),
         "--sync-plane", "master", "--device", "cpu"]
        + (["--heartbeat-file", hb_file] if w == 1 else []),
        env=env) for w in (0, 1)]
    stop = threading.Event()

    def _preempt():
        # the heartbeat file appears once worker 1's watchdog holds the
        # signal handlers; a second later the run is under way
        deadline = time.monotonic() + 60.0
        while not stop.is_set() and time.monotonic() < deadline:
            if os.path.exists(hb_file):
                if not stop.wait(1.0):
                    procs[1].send_signal(signal.SIGTERM)
                return
            time.sleep(0.05)

    killer = threading.Thread(target=_preempt, daemon=True)
    killer.start()
    try:
        with pytest.raises(RuntimeError, match="worker 1 left the run"):
            runtime.run_ps(problems.NUMPY_MLP, CFG, cfg, device="cpu",
                           join_timeout_s=60.0)
    finally:
        stop.set()
        killer.join(timeout=10)
        for p in procs:
            try:
                p.wait(timeout=15)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    assert procs[1].returncode == 0      # a clean exit, not a crash
    assert Watchdog.is_alive(hb_file, timeout_s=60.0)


def test_cluster_launcher_reports_health(tmp_path, capsys):
    jsonl = str(tmp_path / "cluster.jsonl")
    hb = str(tmp_path / "master.hb")
    results = cluster.main(["--workers", "2", "--algorithm", "sync_easgd",
                            "--sync-plane", "p2p", "--iters", "40",
                            "--device", "cpu", "--telemetry-jsonl", jsonl,
                            "--elastic", "--heartbeat-file", hb])
    out = capsys.readouterr().out
    assert len(results) == 1 and results[0].health["epoch"] == 0
    assert "# health: 0 event(s)" in out and f"jsonl={jsonl}" in out
    assert os.path.exists(jsonl) and os.path.exists(hb)

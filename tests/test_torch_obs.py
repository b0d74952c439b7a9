"""The port's tracing (``repro_torch.obs``) on the CPU, against the
reference (``repro.obs``).

 1. ``obs.trace``: preallocated, lock-free, drops past capacity; a
    tracer's ``now()`` calls its device synchronise before the clock.
 2. ``obs.clock``: the min-rtt estimator; over a real socket pair
    |offset| ≤ rtt.
 3. ``obs.report``: merge, the Table-3 breakdown and the Chrome export,
    equal to the reference's on the same payloads.
 4. The runtime traced: tracing off creates no tracer; thread, process
    and tcp traces merge (tcp with a real clock estimate); traced runs
    equal untraced ones bit for bit; the span-measured exposed comm agrees
    with the BYE ``exposed_s`` counter.
"""
import json
import socket
import threading

import numpy as np
import pytest
import torch

from repro.obs import report as ref_report
from repro_torch.core import costmodel
from repro_torch.core.easgd import EASGDConfig
from repro_torch.net import wire
from repro_torch.obs import clock as obs_clock
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import report as obs_report
from repro_torch.obs import trace as obs_trace
from repro_torch.ps import problems, runtime

NET = costmodel.Network("test-net", 2e-6, 1 / 10e9)
CFG = EASGDConfig(eta=0.05, rho=0.07, mu=0.9)


# ---------------------------------------------------------------------------
# (1) obs.trace
# ---------------------------------------------------------------------------

def test_tracer_prealloc_and_overflow_drops():
    t = obs_trace.Tracer("main", wid=3, capacity=4)
    for i in range(6):
        t.record(obs_trace.COMPUTE, float(i), float(i) + 0.5, arg=i)
    assert t.n == 4 and t.dropped == 2
    spans = t.spans()
    assert spans == [[obs_trace.COMPUTE, float(i), float(i) + 0.5, i]
                     for i in range(4)]
    assert json.loads(json.dumps(spans)) == spans


def test_tracer_now_synchronises_before_the_clock():
    calls = []
    t = obs_trace.Tracer("main", sync=lambda: calls.append(1))
    a = t.now()
    b = t.now()
    assert calls == [1, 1] and b >= a
    assert obs_trace.Tracer("main").now() > 0       # no sync on the CPU


def test_registry_drain_and_stats():
    obs_trace.drain()
    a = obs_trace.tracer("main", wid=0, capacity=8)
    b = obs_trace.tracer("comm", wid=0, capacity=8)
    a.record(obs_trace.COMPUTE, 0.0, 1.0)
    st = obs_trace.stats()
    assert st["tracers"] == 2 and st["records"] == 1 and st["dropped"] == 0
    drained = obs_trace.drain()
    assert {t.name for t in drained} == {"main", "comm"} and b in drained
    assert obs_trace.stats() == {"tracers": 0, "records": 0, "dropped": 0}


def test_spill_roundtrip_creates_missing_dir(tmp_path):
    payload = {"clock": {"offset_s": 0.1, "rtt_s": 0.2},
               "threads": {"main": [[0, 1.0, 2.0, 0]]}, "dropped": 0}
    path = obs_trace.dump_spill(str(tmp_path / "deep" / "dir"), 5, payload)
    assert path.endswith("trace-w5.json")
    assert obs_trace.load_spill(path) == payload


def test_span_kinds_and_classes_match_the_reference():
    from repro.obs import trace as ref_trace
    assert obs_trace.KIND_NAMES == ref_trace.KIND_NAMES
    for name in ("COMPUTE_KINDS", "EXPOSED_KINDS", "UPDATE_KINDS",
                 "COMM_BUSY_KINDS"):
        assert getattr(obs_trace, name) == getattr(ref_trace, name)


def test_metrics_registry_and_count_round():
    reg = obs_metrics.Registry()
    reg.add("wire_bytes", 100)
    reg.add("wire_bytes", 50)
    reg.set("hb_staleness_max_s", 1.5)
    ext = obs_metrics.Slot(7)
    assert reg.counter("messages", cell=ext) is ext
    reg["messages"].value += 1
    assert ext.value == 8
    snap = reg.snapshot()
    assert snap["wire_bytes"] == 150 and snap["hb_staleness_max_s"] == 1.5
    assert "messages" in reg and len(reg) == 3

    class _Msg:
        def __init__(self, frac):
            self.frac = frac

    counters = obs_metrics.Registry()
    for name in ("sync_rounds", "messages", "wire_bytes"):
        counters.counter(name)
    obs_metrics.count_round(counters, [_Msg(0.5), _Msg(0.25)], 1000)
    assert counters.snapshot() == {
        "sync_rounds": 1, "messages": 2, "wire_bytes": int(0.75 * 1000 * 8)}


# ---------------------------------------------------------------------------
# (2) obs.clock
# ---------------------------------------------------------------------------

def test_clock_combine_recovers_known_offset_at_min_rtt():
    good = (10.0, 10.05 + 1.5, 10.1)     # rtt 0.1, offset +1.5
    noisy = (20.0, 20.25 + 9.9, 20.5)    # rtt 0.5: queueing-inflated
    cs = obs_clock.combine([noisy, good])
    assert cs.offset_s == pytest.approx(1.5)
    assert cs.rtt_s == pytest.approx(0.1)
    assert cs.probes == 2
    assert json.loads(json.dumps(cs.to_wire()))["offset_s"] == cs.offset_s


def test_clock_sync_over_real_link_offset_bounded_by_rtt():
    a, b = socket.socketpair()
    la, lb = wire.Link(a), wire.Link(b)

    def _echo(n):
        for _ in range(n):
            obs_clock.answer(lb, lb.recv_header(), wid=0)

    th = threading.Thread(target=_echo, args=(5,), daemon=True)
    th.start()
    cs = obs_clock.sync_over_link(la, wid=0, probes=5)
    th.join(timeout=5)
    assert cs.probes == 5 and cs.rtt_s > 0
    assert abs(cs.offset_s) <= cs.rtt_s
    la.close(), lb.close()


# ---------------------------------------------------------------------------
# (3) obs.report
# ---------------------------------------------------------------------------

def _payload(offset, spans, rtt=0.01):
    return {"clock": {"offset_s": offset, "rtt_s": rtt},
            "threads": {"main": spans}, "dropped": 0}


def test_merge_shifts_spans_onto_master_clock():
    spans = [[obs_trace.COMPUTE, 0.0, 1.0, 0]]
    merged = obs_report.merge_traces(
        {0: _payload(2.0, spans), 1: _payload(-1.0, spans)},
        master={"threads": {"serve": [[obs_trace.EVAL, 5.0, 5.1, 0]]}})
    assert merged["workers"][0]["threads"]["main"][0][1:3] == [2.0, 3.0]
    assert merged["workers"][1]["threads"]["main"][0][1:3] == [-1.0, 0.0]
    assert merged["master"]["threads"]["serve"][0][1:3] == [5.0, 5.1]


def test_breakdown_table3_accounting():
    spans = [[obs_trace.COMPUTE, 0.0, 1.0, 0],
             [obs_trace.COMM_WAIT, 1.0, 1.5, 0],
             [obs_trace.UPDATE, 1.5, 1.6, -1],
             [obs_trace.EXCHANGE, 0.2, 0.9, 0]]   # busy, not a share
    rep = obs_report.breakdown(obs_report.merge_traces({0: _payload(0,
                                                                    spans)}))
    w = rep["workers"][0]
    assert w["wall_s"] == pytest.approx(1.6)
    assert w["compute_share"] == pytest.approx(1.0 / 1.6, abs=1e-3)
    assert w["comm_share"] == pytest.approx(0.5 / 1.6, abs=1e-3)
    assert w["update_share"] == pytest.approx(0.1 / 1.6, abs=1e-3)
    assert w["comm_busy_s"] == pytest.approx(0.7)
    assert rep["mean_comm_share"] == w["comm_share"]


def test_chrome_trace_exports_one_pid_per_worker():
    spans = [[obs_trace.COMPUTE, 1.0, 2.0, 0]]
    merged = obs_report.merge_traces(
        {0: _payload(0.0, spans), 1: _payload(0.0, spans)},
        master={"threads": {"serve": [[obs_trace.EVAL, 1.0, 1.1, 0]]}})
    ct = json.loads(json.dumps(obs_report.chrome_trace(merged)))
    xs = [e for e in ct["traceEvents"] if e["ph"] == "X"]
    assert {e["pid"] for e in xs} == {0, 1, 9999}
    assert all(e["ts"] >= 0 and e["dur"] > 0 for e in xs)
    names = {e["args"]["name"] for e in ct["traceEvents"]
             if e["name"] == "process_name"}
    assert names == {"worker 0", "worker 1", "master"}


def test_report_equals_the_reference_on_one_payload():
    rng = np.random.RandomState(0)
    workers = {}
    for wid in range(3):
        t, spans = 0.0, []
        for k in rng.randint(0, 12, size=40):
            d = float(rng.rand())
            spans.append([int(k), t, t + d, int(rng.randint(-1, 4))])
            t += d
        workers[wid] = {"clock": {"offset_s": float(rng.randn()),
                                  "rtt_s": 1e-4},
                        "threads": {"main": spans[:25], "comm": spans[25:]},
                        "dropped": wid}
    master = {"threads": {"serve": [[obs_trace.EVAL, 0.5, 0.75, 0]]}}
    mine = obs_report.merge_traces(workers, master)
    ref = ref_report.merge_traces(workers, master)
    assert mine == ref
    assert obs_report.breakdown(mine) == ref_report.breakdown(ref)
    assert obs_report.chrome_trace(mine) == ref_report.chrome_trace(ref)


# ---------------------------------------------------------------------------
# (4) the runtime, traced
# ---------------------------------------------------------------------------

def _run(algo, transport, iters=24, P=2, **kw):
    kw.setdefault("eval_every_iters", 10**9)
    cfg = runtime.PSConfig(algorithm=algo, n_workers=P, total_iters=iters,
                           transport=transport, schedule="ring", **kw)
    return runtime.run_ps(problems.NUMPY_MLP, CFG, cfg, device="cpu")


def test_tracing_off_is_the_default_and_creates_no_tracer():
    obs_trace.drain()
    res = _run("sync_easgd", "thread", emulate_net=NET)
    assert res.trace is None
    assert obs_trace.stats() == {"tracers": 0, "records": 0, "dropped": 0}


def test_thread_trace_spans_monotone_and_report_sane():
    res = _run("sync_easgd", "thread", emulate_net=NET, trace=True)
    assert set(res.trace["workers"]) == {0, 1}
    for w in res.trace["workers"].values():
        spans = w["threads"]["main"]
        kinds = {s[0] for s in spans}
        assert obs_trace.COMPUTE in kinds and obs_trace.BARRIER in kinds
        assert all(t1 >= t0 for _, t0, t1, _ in spans)
        for prev, cur in zip(spans, spans[1:]):    # sequential sections
            assert cur[1] >= prev[2] - 1e-9
    ex = [s for s in res.trace["master"]["threads"]["comm"]
          if s[0] == obs_trace.EXCHANGE]
    assert len(ex) >= 2
    rep = res.trace["report"]
    assert 0.0 < rep["mean_compute_share"] <= 1.0
    assert 0.0 <= rep["mean_comm_share"] <= 1.0


def test_process_transport_spills_and_merges(tmp_path):
    res = _run("async_easgd", "process", iters=60, trace=True,
               trace_dir=str(tmp_path))
    assert set(res.trace["workers"]) == {0, 1}
    for wid in (0, 1):
        spill = obs_trace.load_spill(obs_trace.spill_path(str(tmp_path), wid))
        assert spill["threads"]["main"]
        assert res.trace["workers"][wid]["threads"]["main"]
    assert "report" in res.trace


def test_tcp_trace_real_clock_sync_and_recv_wait():
    res = _run("sync_easgd", "tcp", trace=True, emulate_net=NET)
    assert set(res.trace["workers"]) == {0, 1}
    for w in res.trace["workers"].values():
        assert w["rtt_s"] > 0
        assert abs(w["offset_s"]) <= w["rtt_s"]
        kinds = {s[0] for s in w["threads"]["main"]}
        assert obs_trace.COMPUTE in kinds and obs_trace.RECV_WAIT in kinds
    assert set(res.counters["link_alpha_s"]) == {0, 1}
    serve = {s[0] for s in res.trace["master"]["threads"]["serve"]}
    assert {obs_trace.EXCHANGE, obs_trace.UPDATE} <= serve
    ct = obs_report.chrome_trace(res.trace)
    assert {e["pid"] for e in ct["traceEvents"] if e["ph"] == "X"} >= {0, 1}


def test_heartbeat_telemetry_reaches_master_counters():
    res = _run("async_easgd", "tcp", iters=240,
               emulate_net=costmodel.PS_WIRE, hb_interval_s=0.05)
    telem = res.counters["worker_telemetry"]
    assert set(telem) <= {0, 1} and len(telem) >= 1
    for t in telem.values():
        assert t["iters"] >= 0 and t["rate_ips"] >= 0


def test_traced_runs_stay_bitwise_identical():
    """Tracing never perturbs the math: thread off, thread on and tcp p2p
    on give the same bits under deterministic admission."""
    kw = dict(iters=48, deterministic=True)
    off = _run("sync_easgd", "thread", **kw)
    on = _run("sync_easgd", "thread", trace=True, **kw)
    p2p = _run("sync_easgd", "tcp", trace=True, sync_plane="p2p", **kw)
    assert off.total_iters == on.total_iters == p2p.total_iters
    assert torch.equal(off.center, on.center)
    assert torch.equal(off.center, p2p.center)
    assert torch.equal(off.workers, on.workers)
    assert torch.equal(off.workers, p2p.workers)
    assert on.trace is not None and p2p.trace is not None


def test_bucketed_p2p_trace_bitwise_and_exposed_matches_counter():
    """Bucketed-overlap p2p with tracing on: bitwise to the monolithic
    thread run, and the span-measured exposed comm agrees with the BYE
    ``exposed_s`` counter (rel 0.25, abs 0.02, as the reference holds
    them)."""
    kw = dict(iters=24, deterministic=True)
    mono = _run("sync_easgd", "thread", **kw)
    res = _run("sync_easgd", "tcp", sync_plane="p2p", trace=True,
               bucket_bytes=4096, overlap=True,
               emulate_net=costmodel.PS_WIRE, **kw)
    assert torch.equal(mono.center, res.center)
    assert torch.equal(mono.workers, res.workers)
    span_exposed = sum(w["exposed_comm_s"]
                       for w in res.trace["report"]["workers"].values())
    counter_exposed = res.counters["exposed_s"]
    assert counter_exposed > 0
    assert span_exposed == pytest.approx(counter_exposed, rel=0.25,
                                         abs=0.02)
    comm_kinds = {s[0] for w in res.trace["workers"].values()
                  for s in w["threads"].get("comm", [])}
    assert obs_trace.BUCKET in comm_kinds

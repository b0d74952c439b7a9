"""The port's tcp transport on the CPU (``repro_torch.net``), against the
reference (``repro.net``, ``repro.ps``).

 1. The wire: framing round trip and counters, the zero-copy receive,
    partial reads, heartbeats, sign-EF payloads with per-link error
    feedback, and the host staging of device rows (``HostRow``).
 2. Rejections: prebuilt closures, deterministic admission with a lossy
    codec, a rendezvous without workers, compression off tcp.
 3. Localhost runs (2–4 spawned worker interpreters each): every family
    completes; under deterministic admission the port's tcp run equals the
    reference's tcp run and the port's thread run bit for bit (center and
    workers); emulated wire time changes the clock, not the math; sign-EF
    cuts the wire bytes at matched loss; the workers' kernel launch counts
    come home in BYE.
"""
import queue
import socket
import threading

import numpy as np
import pytest
import torch

from repro import ps as ref_ps
from repro.core.easgd import EASGDConfig as RefConfig
from repro_torch import kernels
from repro_torch.core import compression, costmodel
from repro_torch.core.easgd import EASGDConfig
from repro_torch.net import wire
from repro_torch.ps import problems, runtime

ETA, RHO, MU = 0.05, 0.07, 0.9
CFG = EASGDConfig(eta=ETA, rho=RHO, mu=MU)
REF_CFG = RefConfig(eta=ETA, rho=RHO, mu=MU)


def _link_pair(codec_a="none", codec_b="none"):
    a, b = socket.socketpair()
    return wire.Link(a, codec=codec_a), wire.Link(b, codec=codec_b)


# ---------------------------------------------------------------------------
# (1) the wire
# ---------------------------------------------------------------------------

def test_wire_array_roundtrip_and_counters():
    counters = {"messages": wire.Slot(), "wire_bytes": wire.Slot()}
    tx, rx = _link_pair()
    tx.counters = counters
    arr = np.random.RandomState(0).randn(1000)
    tx.send_array(wire.WEIGHTS, arr, wid=3)
    frame = rx.recv_header()
    assert frame.ftype == wire.WEIGHTS and frame.wid == 3
    assert frame.size == 8000
    np.testing.assert_array_equal(rx.recv_array(frame), arr)
    assert counters["messages"].value == 1
    assert counters["wire_bytes"].value == 8000 + wire.HEADER_SIZE
    tx.close(), rx.close()


def test_wire_recv_into_lands_in_the_callers_buffer():
    tx, rx = _link_pair()
    arr = np.arange(512, dtype=np.float64)
    out = np.zeros(512)
    tx.send_array(wire.GRAD, arr)
    assert rx.recv_array(rx.recv_header(), out) is out
    np.testing.assert_array_equal(out, arr)
    tx.close(), rx.close()


def test_wire_partial_reads_reassemble():
    """A frame dribbled in 7-byte segments reassembles byte for byte."""
    a, b = socket.socketpair()
    rx = wire.Link(b)
    arr = np.random.RandomState(1).randn(300)
    header = wire._HEADER.pack(wire.MAGIC, wire.VERSION, wire.WEIGHTS, 0, 0,
                               wire.CODEC_NONE, arr.nbytes)
    blob = header + arr.tobytes()

    def _dribble():
        for i in range(0, len(blob), 7):
            a.sendall(blob[i:i + 7])

    th = threading.Thread(target=_dribble)
    th.start()
    got = rx.recv_array(rx.recv_header())
    th.join()
    np.testing.assert_array_equal(got, arr)
    a.close(), rx.close()


def test_wire_heartbeats_are_transparent_and_latch_telemetry():
    tx, rx = _link_pair()
    tx.send_simple(wire.HEARTBEAT)
    tx.send_json(wire.HEARTBEAT, {"iters": 7, "rate_ips": 1.5})
    tx.send_array(wire.GRAD, np.ones(4))
    frame = rx.recv_header()                  # skips both heartbeats
    assert frame.ftype == wire.GRAD
    assert rx.hb_telemetry == {"iters": 7, "rate_ips": 1.5}
    tx.close(), rx.close()


def test_wire_bad_magic_raises():
    a, b = socket.socketpair()
    rx = wire.Link(b)
    a.sendall(b"XX" + bytes(wire.HEADER_SIZE - 2))
    with pytest.raises(wire.WireError, match="bad frame header"):
        rx.recv_header()
    a.close(), rx.close()


def test_sign_ef_roundtrip_and_error_feedback_over_a_link():
    """1 bit an element on the wire; the link's EF state carries the
    residual, so the next frame corrects toward the truth."""
    tx, rx = _link_pair(codec_a="sign_ef")
    arr = np.random.RandomState(4).randn(801)      # odd: padded bit tail
    n_wire = tx.send_array(wire.GRAD, arr)
    assert n_wire == compression.sign_ef_wire_nbytes(801)
    dec = rx.recv_array(rx.recv_header())
    np.testing.assert_allclose(dec, np.sign(arr) * np.abs(arr).mean(),
                               rtol=1e-12)
    err = tx._ef[(wire.GRAD, 801, 0, 0)]
    np.testing.assert_allclose(err, arr - dec, rtol=1e-12)
    tx.send_array(wire.GRAD, arr)
    dec2 = rx.recv_array(rx.recv_header())
    assert (np.abs((dec + dec2) / 2 - arr).mean()
            < np.abs(dec - arr).mean())
    assert tx.ef_ratio() == pytest.approx(2 * arr.nbytes / (2 * n_wire))
    tx.close(), rx.close()


def test_sign_ef_segments_keep_their_own_scales():
    tx, rx = _link_pair(codec_a="sign_ef")
    rng = np.random.RandomState(7)
    grad, w = 0.01 * rng.randn(400), 1.0 + rng.randn(400)
    tx.send_array(wire.GRAD, np.concatenate([grad, w]), segments=2)
    got = rx.recv_array(rx.recv_header())
    np.testing.assert_allclose(np.abs(got[:400]).max(), np.abs(grad).mean(),
                               rtol=1e-9)
    np.testing.assert_allclose(np.abs(got[400:]).max(), np.abs(w).mean(),
                               rtol=1e-9)
    tx.close(), rx.close()


def test_segment_ef_streams_keyed_by_chunk_and_op():
    tx, rx = _link_pair(codec_a="sign_ef")
    arr = np.random.RandomState(5).randn(64)
    tx.send_array(wire.SEGMENT, arr, ef_tag=(0, "add"))
    tx.send_array(wire.SEGMENT, arr, ef_tag=(0, "set"))
    assert len(tx._ef) == 2, list(tx._ef)
    rx.recv_discard(rx.recv_header())
    rx.recv_discard(rx.recv_header())
    tx.close(), rx.close()


def test_raw_frame_bypasses_the_lossy_codec():
    tx, rx = _link_pair(codec_a="sign_ef")
    arr = np.random.RandomState(6).randn(100)
    assert tx.send_array(wire.CENTER, arr, raw=True) == arr.nbytes
    np.testing.assert_array_equal(rx.recv_array(rx.recv_header()), arr)
    tx.close(), rx.close()


def test_host_row_stages_device_rows_both_ways():
    """HostRow.put copies rows end to end into the host buffer the wire
    reads; get copies the buffer back out, in order."""
    host = wire.HostRow(10, "cpu")
    a = torch.arange(4, dtype=torch.float64)
    b = torch.arange(6, dtype=torch.float64) + 10
    view = host.put(a, b)
    np.testing.assert_array_equal(view, np.r_[np.arange(4),
                                              np.arange(6) + 10])
    x = torch.zeros(3, dtype=torch.float64)
    y = torch.zeros(7, dtype=torch.float64)
    host.get(x, y)
    torch.testing.assert_close(torch.cat([x, y]), torch.cat([a, b]),
                               rtol=0, atol=0)
    tx, rx = _link_pair()
    tx.send_array(wire.WEIGHTS, host.put(b))
    out = wire.HostRow(6, "cpu")
    rx.recv_array(rx.recv_header(), out.np)
    got = torch.zeros(6, dtype=torch.float64)
    out.get(got)
    assert torch.equal(got, b)
    tx.close(), rx.close()


def test_measure_link_returns_sane_alpha_beta():
    alpha, beta = wire.measure_link(reps=10, big_bytes=400_000)
    assert 1e-7 <= alpha < 0.5
    assert 1e-12 <= beta < 1e-5


# ---------------------------------------------------------------------------
# (2) rejections
# ---------------------------------------------------------------------------

def _tcp_cfg(algo, P=2, iters=40, **kw):
    kw.setdefault("eval_every_iters", 10**9)
    return runtime.PSConfig(algorithm=algo, n_workers=P, total_iters=iters,
                            transport="tcp", schedule="ring", **kw)


def test_tcp_rejects_prebuilt_closures():
    built = problems.make_numpy_mlp(device="cpu")
    with pytest.raises(ValueError, match="ProblemSpec"):
        runtime.run_ps(built, CFG, _tcp_cfg("async_easgd", iters=10),
                       device="cpu")


def test_tcp_rejects_deterministic_with_compression():
    with pytest.raises(ValueError, match="deterministic"):
        runtime.run_ps(problems.NUMPY_MLP, CFG,
                       _tcp_cfg("async_easgd", deterministic=True,
                                wire_compression="sign_ef"), device="cpu")


def test_tcp_rendezvous_times_out_without_workers():
    cfg = _tcp_cfg("async_easgd", spawn_workers=False)
    with pytest.raises(RuntimeError, match="rendezvous timeout"):
        runtime.run_ps(problems.NUMPY_MLP, CFG, cfg, device="cpu",
                       join_timeout_s=2.0)


@pytest.mark.parametrize("transport", ["thread", "process"])
def test_wire_compression_rejected_off_tcp(transport):
    with pytest.raises(ValueError, match="tcp-transport"):
        runtime.PSConfig(algorithm="async_easgd", transport=transport,
                         wire_compression="sign_ef")


def test_get_transport_names_tcp_and_refuses_others():
    from repro_torch.ps import transport
    assert sorted(transport.TRANSPORTS) == ["process", "tcp", "thread"]
    tr = transport.get_transport("tcp", "cpu")
    assert tr.name == "tcp" and tr.device == torch.device("cpu")
    with pytest.raises(ValueError):
        transport.get_transport("udp", "cpu")


@pytest.mark.parametrize("field,value", [
    ("telemetry", True), ("elastic", True), ("chaos", {"wid": 0}),
])
def test_deferred_features_still_refused_on_tcp(field, value):
    """Telemetry, elastic membership, chaos and topology are ported; of
    them only elastic membership is refused beside a topology (the
    reference's condition: an epoch's survivors no longer tile the
    declared grid)."""
    topo = costmodel.Topology(2, 1)
    if field == "elastic":
        with pytest.raises(ValueError, match="elastic"):
            runtime.PSConfig(algorithm="sync_easgd", transport="tcp",
                             n_workers=2, topology=topo, **{field: value})
    else:
        assert runtime.PSConfig(algorithm="sync_easgd", transport="tcp",
                                n_workers=2, topology=topo,
                                **{field: value}).topology == topo
    cfg = runtime.PSConfig(algorithm="sync_easgd", transport="tcp",
                           **{field: value})
    assert getattr(cfg, field) == value


# ---------------------------------------------------------------------------
# (3) localhost runs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algo", [
    "original_easgd",                  # round-robin family
    "async_sgd", "async_easgd",        # FCFS family
    "async_msgd", "async_measgd",      # FCFS with velocity
    "hogwild_sgd", "hogwild_easgd",    # lock-free family
    "sync_easgd", "sync_sgd",          # barriered family
])
def test_tcp_smoke_every_family(algo):
    """All nine algorithms complete on the master plane."""
    res = runtime.run_ps(problems.NUMPY_MLP, CFG, _tcp_cfg(algo),
                         device="cpu")
    assert res.total_iters == 40
    assert res.transport == "tcp" and res.device == "cpu"
    assert np.isfinite(res.final_metric)
    assert bool(torch.isfinite(res.center).all())
    assert res.counters["messages"] > 0
    assert res.counters["master_link_bytes"] > 0
    assert set(res.counters["worker_ready_s"]) == {0, 1}


def _det_cfg(mod, algo, P, iters, transport, **kw):
    return mod.PSConfig(algorithm=algo, n_workers=P, total_iters=iters,
                        transport=transport, schedule="round_robin",
                        deterministic=True, eval_every_iters=10**9, **kw)


def _det_run(algo, P, iters, transport, easgd=CFG, **kw):
    return runtime.run_ps(problems.NUMPY_MLP, easgd,
                          _det_cfg(runtime, algo, P, iters, transport, **kw),
                          device="cpu")


@pytest.mark.parametrize("algo,P", [
    ("sync_easgd", 2), ("sync_easgd", 3), ("sync_sgd", 4),
    ("async_easgd", 2),
])
def test_tcp_bitwise_with_reference_tcp_and_port_thread(algo, P):
    """Deterministic admission: the port's tcp run equals the reference's
    tcp run and the port's thread run bit for bit — the wire and the host
    staging move every byte faithfully."""
    ref = ref_ps.run_ps(ref_ps.NUMPY_MLP, REF_CFG,
                        _det_cfg(ref_ps, algo, P, 72, "tcp"))
    tcp = _det_run(algo, P, 72, "tcp")
    thread = _det_run(algo, P, 72, "thread")
    assert ref.total_iters == tcp.total_iters == thread.total_iters == 72
    np.testing.assert_array_equal(tcp.center.numpy(), ref.center)
    np.testing.assert_array_equal(tcp.workers.numpy(), ref.workers)
    assert torch.equal(tcp.center, thread.center)
    assert torch.equal(tcp.workers, thread.workers)
    assert tcp.schedule == ref.schedule


@pytest.mark.parametrize("algo", ["async_measgd", "sync_easgd"])
def test_tcp_tau2_stacked_frames_bitwise(algo):
    """τ = 2: async_measgd's frames stack [w|v] down and [grad|w|v] up,
    sync_easgd posts WSTATE before its gradient. The port's tcp run equals
    the reference's tcp run bit for bit, center and workers, and the
    thread run's center. (The workers' rows differ from the thread run's:
    there a worker's local steps after its last exchange land in the
    shared rows; over tcp the master keeps its last received copy.)"""
    e = EASGDConfig(eta=ETA, rho=RHO, mu=MU, tau=2)
    ref = ref_ps.run_ps(ref_ps.NUMPY_MLP,
                        RefConfig(eta=ETA, rho=RHO, mu=MU, tau=2),
                        _det_cfg(ref_ps, algo, 2, 48, "tcp"))
    tcp = _det_run(algo, 2, 48, "tcp", easgd=e)
    thread = _det_run(algo, 2, 48, "thread", easgd=e)
    assert ref.total_iters == tcp.total_iters == thread.total_iters == 48
    np.testing.assert_array_equal(tcp.center.numpy(), ref.center)
    np.testing.assert_array_equal(tcp.workers.numpy(), ref.workers)
    assert torch.equal(tcp.center, thread.center)


class _LateReady(queue.Queue):
    """The master's event queue with worker 1's READY, and what follows it,
    held back until worker 0, READY before it, has sent an event of its
    run: the order a loaded machine can give the p2p plane, whose workers
    start without a word from the master."""

    def __init__(self):
        super().__init__()
        self.held = []
        self.early = []
        self.order = threading.Lock()    # the links' readers put at once

    def put(self, item, *args, **kwargs):
        wid, kind, _ = item
        with self.order:
            if wid == 1 and not self.early and (self.held
                                                or kind == "ready"):
                self.held.append(item)
                return
            super().put(item, *args, **kwargs)
            if wid == 0 and kind != "ready" and not self.early:
                # worker 1's READY is held, or has not come yet
                self.early.append(kind)
                for held in self.held:
                    super().put(held)
                self.held = []


def test_tcp_rendezvous_holds_a_ready_workers_early_event(monkeypatch):
    """A READY worker's event that reaches the master before every worker
    is READY waits for the serve loop: the p2p run finishes and equals the
    same run in the usual order bit for bit."""
    from repro_torch.net import server
    kw = dict(sync_plane="p2p", eval_every_iters=10**9)
    plain = runtime.run_ps(problems.NUMPY_MLP, CFG,
                           _tcp_cfg("sync_easgd", iters=24, **kw),
                           device="cpu")
    queues = []
    init = server.MasterServer.__init__

    def late(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self.events = _LateReady()
        queues.append(self.events)
    monkeypatch.setattr(server.MasterServer, "__init__", late)
    res = runtime.run_ps(problems.NUMPY_MLP, CFG,
                         _tcp_cfg("sync_easgd", iters=24, **kw),
                         device="cpu")
    assert len(queues) == 1 and queues[0].early, "no event came early"
    assert res.total_iters == plain.total_iters == 24
    assert torch.equal(res.center, plain.center)
    assert torch.equal(res.workers, plain.workers)


def test_tcp_emulated_wire_changes_clock_not_math():
    slow = costmodel.Network("tiny-emu", 1e-3, 1e-9)
    a = _det_run("async_easgd", 2, 40, "tcp")
    b = _det_run("async_easgd", 2, 40, "tcp", emulate_net=slow)
    assert torch.equal(a.center, b.center)
    assert b.total_time_s > 40 * 2 * 1e-3     # the wire time was paid


def test_tcp_sign_ef_cuts_wire_bytes_at_matched_loss():
    runs = {}
    for codec in ("none", "sign_ef"):
        cfg = _tcp_cfg("async_easgd", iters=240, wire_compression=codec,
                       eval_every_iters=120)
        runs[codec] = runtime.run_ps(
            problems.NUMPY_MLP, EASGDConfig(eta=0.1, rho=0.1, mu=0.9), cfg,
            device="cpu")
    b_none = runs["none"].counters["wire_bytes"]
    b_sign = runs["sign_ef"].counters["wire_bytes"]
    assert b_none >= 4 * b_sign, (b_none, b_sign)
    assert runs["sign_ef"].counters["ef_ratio"] > 30
    assert runs["sign_ef"].final_metric <= runs["none"].final_metric + 0.10


def test_tcp_counters_count_real_frames():
    """FCFS, 2 workers, τ = 1: one GRAD up and one WEIGHTS down an
    exchange, plus the initial distribution and the grads in flight at
    shutdown; besides them each link counts four control frames with a
    payload (HELLO, WELCOME, DONE, and BYE with the launch counts). The
    heartbeat period outlasts the run, so no heartbeat is counted."""
    res = runtime.run_ps(problems.NUMPY_MLP, CFG,
                         _tcp_cfg("async_easgd", iters=30,
                                  hb_interval_s=30.0), device="cpu")
    n = res.center.numel()
    frames = res.counters["messages"] - 2 * 4
    assert 2 * 30 <= frames <= 2 * 30 + 3 * 2, res.counters["messages"]
    assert (res.counters["wire_bytes"]
            >= frames * (n * 8 + wire.HEADER_SIZE))
    assert res.counters["master_link_bytes"] == res.counters["wire_bytes"]


def make_counting_mlp(device=None, **kw):
    """The numpy MLP whose every gradient adds one to ``fused_ce_fwd``'s
    count, standing in for a kernel launched inside a tcp worker."""
    from repro_torch.kernels import _build
    w0, grad_fn, eval_fn = problems.make_numpy_mlp(device=device, **kw)

    def counted(w, step, worker):
        _build.count_launch(kernels.fused_ce_fwd)
        return grad_fn(w, step, worker)

    counted.layer_sizes = grad_fn.layer_sizes
    return w0, counted, eval_fn


def test_worker_launch_counts_come_home_in_bye(monkeypatch):
    """Each worker process counts its launches; BYE carries them and the
    master adds them to its own: 2 warm-up gradients a worker, then one
    gradient an iteration (sync_sgd at P = 2, 24 iterations)."""
    import os
    tests = os.path.dirname(os.path.abspath(__file__))
    monkeypatch.setenv("PYTHONPATH", tests + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
    kernels.reset_launch_counts()
    res = runtime.run_ps(problems.spec("test_torch_net:make_counting_mlp"),
                         CFG, _tcp_cfg("sync_sgd", iters=24), device="cpu")
    counts = kernels.launch_counts()
    kernels.reset_launch_counts()
    assert res.total_iters == 24
    assert counts["fused_ce_fwd"] == 2 * 2 + 24, counts
    assert sum(counts.values()) == counts["fused_ce_fwd"]

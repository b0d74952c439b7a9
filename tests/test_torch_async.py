"""The port's asynchronous disciplines, DES and process transport on the
CPU, against the reference (``repro.core.easgd_flat``, ``repro.core.
async_engine``, ``repro.core.des``, ``repro.ps``).

On the numpy MLP the gradients are the reference's own numpy code and every
update keeps the reference's operation order, so under deterministic
admission the port's real runs, its DES and the reference's runs and DES
all give the same bits: center, workers, counters, clock and history.
"""
import dataclasses
import io
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from repro import ps as ref_ps
from repro.core import async_engine as ref_engine
from repro.core import costmodel as ref_costmodel
from repro.core import des as ref_des
from repro.core import easgd_flat as ref_flat
from repro.core.easgd import EASGDConfig as RefConfig
from repro_torch import kernels
from repro_torch.core import async_engine, costmodel, des, easgd_flat
from repro_torch.core.easgd import EASGDConfig
from repro_torch.kernels import _build
from repro_torch.launch import train
from repro_torch.ps import problems, runtime

ETA, RHO, MU = 0.05, 0.07, 0.9
CFG = EASGDConfig(eta=ETA, rho=RHO, mu=MU)
REF_CFG = RefConfig(eta=ETA, rho=RHO, mu=MU)
ALGORITHMS = async_engine.ALGORITHMS


def make_counting_mlp(device=None, **kw):
    """The numpy MLP whose every gradient adds one to ``fused_ce_fwd``'s
    count, standing in for a kernel launched inside a process worker."""
    w0, grad_fn, eval_fn = problems.make_numpy_mlp(device=device, **kw)

    def counted(w, step, worker):
        _build.count_launch(kernels.fused_ce_fwd)
        return grad_fn(w, step, worker)

    return w0, counted, eval_fn


def make_mlp_failing_in_workers(device=None):
    """The numpy MLP in the launcher; a build error in a process worker."""
    import multiprocessing
    if multiprocessing.parent_process() is not None:
        raise RuntimeError("worker-side build failure")
    return problems.make_numpy_mlp(device=device)


COUNTING_MLP = problems.spec("test_torch_async:make_counting_mlp")
FAILING_MLP = problems.spec("test_torch_async:make_mlp_failing_in_workers")


def _rows(seed=0, n=257):
    rng = np.random.RandomState(seed)
    return [rng.randn(n) for _ in range(6)]


def _t(a):
    return torch.from_numpy(a.copy())


def _counting(problem):
    """A prebuilt problem whose gradient calls are counted."""
    w0, grad_fn, eval_fn = problem.build("cpu")
    calls = [0]

    def counted(w, step, worker):
        calls[0] += 1
        return grad_fn(w, step, worker)

    return (w0, counted, eval_fn), calls


# ---------------------------------------------------------------------------
# core/easgd_flat: the per-arrival updates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algo", ALGORITHMS)
def test_flat_updates_bitwise_vs_reference(algo):
    """``master_absorb`` (async / Hogwild), ``master_absorb_round_robin``
    (Original), the worker rule (sync) and ``local_step`` (all nine) equal
    the reference's numpy updates bit for bit."""
    c, mv, w, v, g, _ = _rows(seed=len(algo))
    ref = [a.copy() for a in (c, mv, w, v)]
    port = [_t(a) for a in (c, mv, w, v)]
    if algo in ref_flat.ASYNC_FAMILY + ref_flat.HOGWILD_FAMILY:
        ref_flat.master_absorb(algo, *ref, g, REF_CFG)
        easgd_flat.master_absorb(algo, *port, _t(g), CFG)
    elif algo == "original_easgd":
        ref_flat.master_absorb_round_robin(ref[0], ref[2], ref[3], g,
                                           REF_CFG)
        easgd_flat.master_absorb_round_robin(port[0], port[2], port[3],
                                             _t(g), CFG)
    else:
        ref_flat.worker_step(algo, ref[2], ref[3], g, ref[0], REF_CFG)
        easgd_flat.worker_step(algo, port[2], port[3], _t(g), port[0], CFG)
    ref_flat.local_step(algo, ref[2], ref[3], g, REF_CFG)
    easgd_flat.local_step(algo, port[2], port[3], _t(g), CFG)
    for got, want in zip(port, ref):
        np.testing.assert_array_equal(got.numpy(), want)
    assert easgd_flat.ASYNC_FAMILY == ref_flat.ASYNC_FAMILY
    assert easgd_flat.HOGWILD_FAMILY == ref_flat.HOGWILD_FAMILY


# ---------------------------------------------------------------------------
# core/async_engine: the DES
# ---------------------------------------------------------------------------

def _des_pair(algo, jitter, p=3, iters=48, schedule="ring", topo=None):
    kw = dict(n_workers=p, compute_jitter=jitter, seed=3, schedule=schedule,
              eval_every_iters=10)
    w0, grad_fn, eval_fn = ref_ps.make_numpy_mlp()
    ref_topo = None if topo is None else ref_costmodel.Topology(
        topo.hosts, topo.slots,
        ref_costmodel.Network(*dataclasses.astuple(topo.intra)),
        ref_costmodel.Network(*dataclasses.astuple(topo.cross)))
    ref = ref_engine.PSEngine(grad_fn, eval_fn, w0, REF_CFG,
                              ref_engine.SimConfig(topology=ref_topo, **kw)
                              ).run(algo, total_iters=iters)
    w0, grad_fn, eval_fn = problems.make_numpy_mlp(device="cpu")
    port = async_engine.PSEngine(grad_fn, eval_fn, w0, CFG,
                                 async_engine.SimConfig(topology=topo, **kw)
                                 ).run(algo, total_iters=iters)
    return ref, port


def _assert_des_equal(ref, port):
    np.testing.assert_array_equal(port.center.numpy(), ref.center)
    np.testing.assert_array_equal(port.workers.numpy(), ref.workers)
    assert port.total_time_s == ref.total_time_s
    assert port.total_iters == ref.total_iters
    assert port.breakdown == ref.breakdown
    assert port.history == ref.history
    assert port.final_metric == ref.final_metric


@pytest.mark.parametrize("jitter", [0.0, 0.1])
@pytest.mark.parametrize("algo", ALGORITHMS)
def test_des_bitwise_vs_reference(algo, jitter):
    """Same seed, same event order: the iterates, the simulated clock, the
    breakdown and the history equal the reference's, jitter on or off."""
    _assert_des_equal(*_des_pair(algo, jitter))


def test_des_prices_a_topology_as_the_reference():
    topo = costmodel.Topology(2, 2, costmodel.PS_WIRE,
                              costmodel.Network("slow", 1e-3, 4 / 9e6))
    _assert_des_equal(*_des_pair("sync_easgd", 0.1, p=4, schedule="tree",
                                 topo=topo))


# ---------------------------------------------------------------------------
# the DES↔real cross-check and the real runs
# ---------------------------------------------------------------------------

def _port_real(algo, p, iters, transport_name="thread", **kw):
    cfg = runtime.PSConfig(algorithm=algo, n_workers=p, total_iters=iters,
                           transport=transport_name, schedule="round_robin",
                           deterministic=True, eval_every_iters=10**9, **kw)
    return runtime.run_ps(problems.NUMPY_MLP, CFG, cfg, device="cpu")


@pytest.mark.parametrize("algo,p", [
    ("async_easgd", 2), ("async_easgd", 4),
    ("sync_easgd", 2), ("sync_easgd", 3), ("sync_easgd", 4),
    ("original_easgd", 3), ("sync_sgd", 4), ("async_measgd", 2),
])
def test_des_real_iterates_bitwise(algo, p):
    """The reference's cross-check, ported: the port's DES at zero jitter
    equals the port's real run under deterministic admission, and that run
    equals the reference's real run — center, workers, counters and
    iteration count, bit for bit."""
    iters = 72
    w0, grad_fn, eval_fn = problems.make_numpy_mlp(device="cpu")
    des_run = async_engine.PSEngine(
        grad_fn, eval_fn, w0, CFG,
        async_engine.SimConfig(n_workers=p, compute_jitter=0.0, seed=0,
                               schedule="round_robin")
    ).run(algo, total_iters=iters)
    real = _port_real(algo, p, iters)
    ref = ref_ps.run_ps(ref_ps.NUMPY_MLP, REF_CFG, ref_ps.PSConfig(
        algorithm=algo, n_workers=p, total_iters=iters, transport="thread",
        schedule="round_robin", deterministic=True, eval_every_iters=10**9))
    assert des_run.total_iters == real.total_iters == ref.total_iters
    assert torch.equal(des_run.center, real.center)
    assert torch.equal(des_run.workers, real.workers)
    np.testing.assert_array_equal(real.center.numpy(), ref.center)
    np.testing.assert_array_equal(real.workers.numpy(), ref.workers)
    assert real.counters == ref.counters
    assert real.schedule == ref.schedule


@pytest.mark.parametrize("algo", ALGORITHMS)
def test_every_algorithm_runs_thread(algo):
    cfg = runtime.PSConfig(algorithm=algo, n_workers=2, total_iters=40,
                           schedule="ring", eval_every_iters=20)
    res = runtime.run_ps(problems.NUMPY_MLP, CFG, cfg, device="cpu")
    assert res.total_iters == 40
    assert np.isfinite(res.final_metric)
    assert bool(torch.isfinite(res.center).all())
    assert len(res.history) >= 2     # the monitor's points and the final one
    assert res.schedule == ("ring" if algo in easgd_flat.SYNC_FAMILY
                            else "master")
    if algo not in easgd_flat.SYNC_FAMILY:
        assert res.counters["messages"] == 2 * 40
        assert res.counters["wire_bytes"] == 2 * 40 * res.center.numel() * 8


def test_monitor_point_of_a_run_that_ends_before_the_first_poll(
        monkeypatch):
    """A run that ends before the monitor's first look (a short run under
    load) still has the point of the eval interval it crossed, stamped at
    the run's end, beside the final one."""
    monkeypatch.setattr(runtime, "any", lambda alive: False, raising=False)
    cfg = runtime.PSConfig(algorithm="async_sgd", n_workers=2,
                           total_iters=40, schedule="ring",
                           eval_every_iters=20)
    res = runtime.run_ps(problems.NUMPY_MLP, CFG, cfg, device="cpu")
    assert res.total_iters == 40
    assert [it for _, it, _ in res.history] == [40, 40]
    assert res.history[0][0] == res.history[1][0]
    assert all(np.isfinite(m) for _, _, m in res.history)


@pytest.mark.parametrize("algo,deterministic,extra", [
    ("original_easgd", False, 0),    # computes inside its turn
    ("async_easgd", True, 2),        # ahead of its turn: one spare each
    ("hogwild_easgd", False, 0),     # per-worker quota
    ("hogwild_sgd", True, 2),        # deterministic: the turnstile
])
def test_gradient_counts_per_discipline(algo, deterministic, extra):
    """What chip_smoke's exact launch counts rest on: every worker warms up
    on 2 gradients; the turnstile and Hogwild then compute the quota (the
    async family under the turnstile one more per worker)."""
    p, iters = 2, 24
    built, calls = _counting(problems.NUMPY_MLP)
    cfg = runtime.PSConfig(algorithm=algo, n_workers=p, total_iters=iters,
                           deterministic=deterministic,
                           eval_every_iters=10**9)
    runtime.run_ps(built, CFG, cfg, device="cpu")
    assert calls[0] == 2 * p + iters + extra


def test_fcfs_gradients_and_counters_under_contention():
    """FCFS under many threads and a short switch interval: the counters,
    bumped under the master lock, never lose an update, and the unused
    gradients number at most P − 1; Hogwild's counters, under their own
    lock, are exact too."""
    p, iters = 8, 160
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        built, calls = _counting(problems.NUMPY_MLP)
        fcfs = runtime.run_ps(built, CFG, runtime.PSConfig(
            algorithm="async_easgd", n_workers=p, total_iters=iters,
            eval_every_iters=10**9), device="cpu", join_timeout_s=120)
        hog = runtime.run_ps(problems.NUMPY_MLP, CFG, runtime.PSConfig(
            algorithm="hogwild_easgd", n_workers=p, total_iters=iters,
            eval_every_iters=10**9), device="cpu", join_timeout_s=120)
    finally:
        sys.setswitchinterval(old)
    assert fcfs.total_iters == iters
    assert fcfs.counters["messages"] == 2 * iters
    assert 2 * p + iters <= calls[0] <= 2 * p + iters + p - 1
    assert hog.counters["messages"] == 2 * iters
    assert bool(torch.isfinite(hog.center).all())


@pytest.mark.parametrize("algo", ["async_easgd", "async_measgd",
                                  "sync_easgd", "hogwild_easgd",
                                  "original_easgd"])
def test_tau_cuts_wire_traffic_by_tau(algo):
    """τ = 4 moves exactly 1/4 of τ = 1's messages and bytes for the same
    number of gradient steps (the reference's count test; its wall-clock
    fraction sweep is not ported)."""
    res = {}
    for tau in (1, 4):
        cfg = runtime.PSConfig(algorithm=algo, n_workers=2, total_iters=48,
                               schedule="ring", eval_every_iters=10**9)
        res[tau] = runtime.run_ps(
            problems.NUMPY_MLP, EASGDConfig(eta=0.1, rho=0.1, mu=0.9,
                                            tau=tau), cfg, device="cpu")
    assert res[1].total_iters == res[4].total_iters == 48
    assert res[1].counters["wire_bytes"] == 4 * res[4].counters["wire_bytes"]
    assert res[1].counters["messages"] == 4 * res[4].counters["messages"]
    assert np.isfinite(res[4].final_metric)


def test_emulated_wire_changes_clock_not_math():
    slow = costmodel.Network("tiny-emu", 1e-4, 1e-9)
    a = _port_real("async_easgd", 2, 40)
    b = _port_real("async_easgd", 2, 40, emulate_net=slow)
    assert torch.equal(a.center, b.center)
    assert b.total_time_s > 40 * 2 * 1e-4    # the wire time was paid


# ---------------------------------------------------------------------------
# the process transport
# ---------------------------------------------------------------------------

def test_process_transport_runs_and_counts():
    cfg = runtime.PSConfig(algorithm="async_easgd", n_workers=2,
                           total_iters=60, transport="process",
                           schedule="ring", eval_every_iters=30)
    res = runtime.run_ps(problems.NUMPY_MLP, CFG, cfg, device="cpu")
    assert res.total_iters == 60
    assert res.counters["messages"] == 120
    assert np.isfinite(res.final_metric)


def test_process_transport_rejects_closures():
    cfg = runtime.PSConfig(algorithm="async_easgd", n_workers=2,
                           total_iters=10, transport="process")
    with pytest.raises(ValueError, match="ProblemSpec"):
        runtime.run_ps(problems.NUMPY_MLP.build("cpu"), CFG, cfg,
                       device="cpu")


@pytest.mark.parametrize("algo", ["async_easgd", "sync_easgd"])
def test_process_equals_thread_bitwise(algo):
    """Deterministic admission orders the processes as it orders the
    threads: the same bits, counters and iteration count."""
    proc = _port_real(algo, 2, 48, "process")
    thread = _port_real(algo, 2, 48)
    assert torch.equal(proc.center, thread.center)
    assert torch.equal(proc.workers, thread.workers)
    assert proc.counters == thread.counters
    assert proc.total_iters == thread.total_iters == 48


def test_process_launch_counts_come_back():
    """Each process worker's launch counts reach the launcher's
    ``kernels.launch_counts()``: P workers × (2 warm-ups + their quota)."""
    p, iters = 2, 20
    kernels.reset_launch_counts()
    runtime.run_ps(COUNTING_MLP, CFG, runtime.PSConfig(
        algorithm="hogwild_sgd", n_workers=p, total_iters=iters,
        transport="process", eval_every_iters=10**9), device="cpu")
    counts = kernels.launch_counts()
    kernels.reset_launch_counts()
    # the launcher builds the problem too, but takes no gradient
    assert counts["fused_ce_fwd"] == 2 * p + iters
    assert sum(counts.values()) == counts["fused_ce_fwd"]


def test_failing_process_worker_fails_the_run():
    """A worker that fails to start fails the run (the watchdog breaks the
    start barrier), with no fallback to threads."""
    cfg = runtime.PSConfig(algorithm="async_easgd", n_workers=2,
                           total_iters=10, transport="process")
    with pytest.raises(RuntimeError, match="failed to start"):
        runtime.run_ps(FAILING_MLP, CFG, cfg, device="cpu",
                       join_timeout_s=120)


# ---------------------------------------------------------------------------
# calibration, core/des, the launcher, what stays unported
# ---------------------------------------------------------------------------

def test_calibration_sim_config_discipline():
    """original_easgd is priced at the serialized compute; the concurrent
    families at the concurrent rate; an explicit net is passed through."""
    cal = runtime.Calibration(n=1000, n_workers=4, transport="thread",
                              t_grad_serial=1e-3, t_grad_concurrent=3e-3,
                              t_axpy=1e-5, alpha=2e-5)
    assert cal.sim_config("original_easgd", "ring").t_compute == 1e-3
    assert cal.sim_config("async_easgd", "ring").t_compute == 3e-3
    net = costmodel.Network("test-net", 2e-6, 1 / 10e9)
    assert cal.sim_config("sync_easgd", "ring", net=net).net is net
    shm = cal.sim_config("hogwild_sgd", "ring").net
    assert (shm.alpha, shm.beta) == (2e-5, 1e-5 / 8000)
    assert cal.sim_config("sync_sgd", "tree").compute_jitter == 0.0


@pytest.mark.parametrize("transport_name", ["thread", "process"])
def test_calibrate_and_run_vs_des_on_cpu(transport_name):
    cfg = runtime.PSConfig(algorithm="async_easgd", n_workers=2,
                           total_iters=24, transport=transport_name,
                           eval_every_iters=10**9)
    cal = runtime.calibrate(problems.NUMPY_MLP, cfg, samples=3, device="cpu")
    assert cal.n == problems.NUMPY_MLP.build("cpu")[0].numel()
    assert min(cal.t_grad_serial, cal.t_grad_concurrent, cal.t_axpy,
               cal.alpha) > 0
    res, des_run, rec = runtime.run_vs_des(problems.NUMPY_MLP, CFG, cfg,
                                           cal=cal, device="cpu")
    assert rec["iters"] == res.total_iters == des_run.total_iters == 24
    assert rec["device"] == "cpu" and rec["schedule"] == "master"
    assert rec["measured_over_des"] == pytest.approx(
        rec["measured_us_per_iter"] / rec["des_us_per_iter"])


_GPU_BOX = ref_des.GpuBox()


@pytest.mark.parametrize("case", [
    ("breakdown_original_easgd", (1000,), dict(overlap=True)),
    ("breakdown_original_easgd", (5000,), dict(overlap=False)),
    ("breakdown_sync_easgd", (1000,), dict(weights_on="cpu", overlap=False)),
    ("breakdown_sync_easgd", (1000,), dict(weights_on="gpu", overlap=True,
                                           schedule="ring")),
    ("breakdown_sync_easgd", (777,), dict(weights_on="gpu", overlap=False,
                                          schedule="butterfly")),
], ids=lambda c: f"{c[0]}-{c[2]}")
def test_des_breakdowns_equal_reference(case):
    name, args, kw = case
    ref = getattr(ref_des, name)(ref_des.GPU_BOX, *args, **kw)
    port = getattr(des, name)(des.GPU_BOX, *args, **kw)
    assert port.parts == ref.parts and port.iters == ref.iters
    assert port.total_s == ref.total_s
    assert port.comm_ratio == ref.comm_ratio
    assert dataclasses.asdict(des.GPU_BOX) == dataclasses.asdict(_GPU_BOX)


@pytest.mark.parametrize("schedule", ["tree", "ring", "psum", "butterfly"])
def test_des_scaling_models_equal_reference(schedule):
    net, ref_net = (costmodel.Network("IB", 0.7e-6, 0.2e-9 / 4),
                    ref_costmodel.Network("IB", 0.7e-6, 0.2e-9 / 4))
    for n_parts in (1, 2, 4, 8, 16, 32):
        kw = dict(t_compute_1=2.5, weight_bytes=2.4e8,
                  fast_mem_bytes=16e9, data_bytes=6e8, schedule=schedule)
        assert des.partition_sweep_time(n_parts, net=net, **kw) == \
            ref_des.partition_sweep_time(n_parts, net=ref_net, **kw)
        for sigma, overlap in ((0.0, True), (0.07, True), (0.07, False)):
            kw = dict(t_compute=0.3, weight_bytes=2.4e8,
                      jitter_sigma=sigma, overlap=overlap, schedule=schedule)
            assert des.weak_scaling_efficiency(n_parts, net=net, **kw) == \
                ref_des.weak_scaling_efficiency(n_parts, net=ref_net, **kw)
    topo = costmodel.Topology(2, 4, net, costmodel.Network("x", 1e-5, 1e-9))
    ref_topo = ref_costmodel.Topology(2, 4, ref_net,
                                      ref_costmodel.Network("x", 1e-5, 1e-9))
    kw = dict(t_compute=0.3, weight_bytes=2.4e8, jitter_sigma=0.05,
              schedule="ring" if schedule == "psum" else schedule)
    assert des.weak_scaling_efficiency(8, net=net, topology=topo, **kw) == \
        ref_des.weak_scaling_efficiency(8, net=ref_net, topology=ref_topo,
                                        **kw)
    for eff in (0.5, 0.9, 0.99):
        assert des.jitter_from_two_node_eff(eff) == \
            ref_des.jitter_from_two_node_eff(eff)


def test_launcher_runs_all_nine_with_des_columns():
    """``--mode ps`` defaults to ``--algorithm all``: one line per
    algorithm, each with the reference's measured / des / ratio columns."""
    out = io.StringIO()
    with redirect_stdout(out):
        results = train.main(["--mode", "ps", "--ps-workers", "2",
                              "--ps-iters", "16", "--emulate", "none",
                              "--device", "cpu"])
    lines = out.getvalue().splitlines()
    assert [r.algorithm for r in results] == list(ALGORITHMS)
    assert len(lines) == 9
    for line, algo in zip(lines, ALGORITHMS):
        assert line.startswith(algo) and "@cpu]" in line
        for col in ("measured=", "us/iter des=", "us/iter ratio=",
                    "launches="):
            assert col in line, (col, line)
        err = float(line.split("err=")[1].split()[0])
        assert np.isfinite(err)


@pytest.mark.parametrize("field,value", [
    ("telemetry", True), ("elastic", True), ("chaos", {"wid": 1}),
    ("topology", costmodel.Topology(2, 2))])
def test_unported_stay_raising(field, value):
    """Every feature is ported: elastic membership and chaos are accepted
    on tcp alone, and a topology (the sync family's) is refused for an
    asynchronous discipline, with the reference's message."""
    kw = {"algorithm": "async_easgd", field: value}
    if field == "topology":
        with pytest.raises(ValueError, match="sync family"):
            runtime.PSConfig(**kw)
    elif field in ("elastic", "chaos"):
        with pytest.raises(ValueError, match="tcp"):
            runtime.PSConfig(**kw)
        assert getattr(runtime.PSConfig(transport="tcp", **kw),
                       field) == value
    else:
        assert getattr(runtime.PSConfig(**kw), field) == value
    with pytest.raises(ValueError):
        runtime.PSConfig(algorithm="nope")

"""The port's PS runtime (``repro_torch.ps.run_ps`` on the CPU) against the
reference ``repro.ps.run_ps``: the Sync EASGD / Sync SGD slice as a whole.

On the numpy MLP the gradients are the reference's own numpy code and every
update keeps the reference's operation order, so the final center, the
workers and the exchange counters are equal BIT FOR BIT — the pins of
tests/test_bucketing.py, ported. On AlexNet the gradients come from
PyTorch instead of XLA, so a short run is held to a relative norm.
"""
import io
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from repro import ps as ref_ps
from repro.core.easgd import EASGDConfig as RefConfig
from repro.ps import zoo as ref_zoo
from repro_torch import kernels
from repro_torch.core import costmodel
from repro_torch.core.easgd import EASGDConfig
from repro_torch.launch import train
from repro_torch.ps import problems, runtime, zoo

ETA, RHO, MU = 0.05, 0.07, 0.9


def _pair(algo, p, schedule, bucket_bytes, iters=36, tau=1):
    ref = ref_ps.run_ps(
        ref_ps.NUMPY_MLP, RefConfig(eta=ETA, rho=RHO, mu=MU, tau=tau),
        ref_ps.PSConfig(algorithm=algo, n_workers=p, total_iters=iters,
                        transport="thread", schedule=schedule,
                        eval_every_iters=10**9, bucket_bytes=bucket_bytes))
    port = runtime.run_ps(
        problems.NUMPY_MLP, EASGDConfig(eta=ETA, rho=RHO, mu=MU, tau=tau),
        runtime.PSConfig(algorithm=algo, n_workers=p, total_iters=iters,
                         schedule=schedule, eval_every_iters=10**9,
                         bucket_bytes=bucket_bytes), device="cpu")
    return ref, port


def _assert_bitwise(ref, port):
    np.testing.assert_array_equal(port.center.numpy(), ref.center)
    np.testing.assert_array_equal(port.workers.numpy(), ref.workers)
    for key in ("sync_rounds", "messages", "wire_bytes"):
        assert port.counters[key] == ref.counters[key], key
    assert port.total_iters == ref.total_iters
    assert port.final_metric == ref.final_metric


@pytest.mark.parametrize("bucket_bytes", [0, 256])
@pytest.mark.parametrize("algo", ["sync_easgd", "sync_sgd"])
@pytest.mark.parametrize("schedule,p", [
    ("ring", 2), ("ring", 3), ("ring", 4), ("tree", 2), ("tree", 4)])
def test_numpy_mlp_bitwise_vs_reference(algo, schedule, p, bucket_bytes):
    _assert_bitwise(*_pair(algo, p, schedule, bucket_bytes))


@pytest.mark.parametrize("algo", ["sync_easgd", "sync_sgd"])
@pytest.mark.parametrize("schedule,p", [
    ("butterfly", 4), ("hierarchical", 4), ("round_robin", 3), ("psum", 4)])
def test_other_schedules_bitwise_vs_reference(algo, schedule, p):
    _assert_bitwise(*_pair(algo, p, schedule, 256))


@pytest.mark.parametrize("algo", ["sync_easgd", "sync_sgd"])
def test_tau_local_steps_bitwise_vs_reference(algo):
    """τ = 2: one local-only step (``easgd_flat.local_step``) between
    exchanges, and an odd round count (the center flip is copied back)."""
    _assert_bitwise(*_pair(algo, 3, "ring", 0, iters=30, tau=2))


def test_emulated_wire_paces_without_touching_the_math():
    cfg = runtime.PSConfig(algorithm="sync_easgd", n_workers=2,
                           total_iters=8, eval_every_iters=10**9,
                           emulate_net=costmodel.Network("t", 2e-3, 0.0))
    easgd = EASGDConfig(eta=ETA, rho=RHO, mu=MU)
    paced = runtime.run_ps(problems.NUMPY_MLP, easgd, cfg, device="cpu")
    free = runtime.run_ps(problems.NUMPY_MLP, easgd,
                          runtime.PSConfig(algorithm="sync_easgd",
                                           n_workers=2, total_iters=8,
                                           eval_every_iters=10**9),
                          device="cpu")
    assert torch.equal(paced.center, free.center)
    # 4 rounds × 2 ring rounds × 2 ms of emulated wire
    assert paced.total_time_s >= 4 * 2 * 2e-3


def test_alexnet_short_run_matches_reference():
    """Full-width AlexNet (6,976,842 parameters), sync_easgd, ring, P = 2,
    4 iterations, the reference's init carried across: the final center
    and the center's movement agree to a relative norm ≤ 1e-5."""
    built = ref_zoo.make_zoo_cnn("alexnet")
    cfg = dict(algorithm="sync_easgd", n_workers=2, total_iters=4,
               schedule="ring", eval_every_iters=10**9, bucket_bytes=4 << 20)
    ref = ref_ps.run_ps(built, RefConfig(eta=0.005, rho=0.01, mu=MU),
                        ref_ps.PSConfig(**cfg))
    port = runtime.run_ps(
        zoo.make_zoo_cnn("alexnet", w0=built[0], device="cpu"),
        EASGDConfig(eta=0.005, rho=0.01, mu=MU), runtime.PSConfig(**cfg),
        device="cpu")
    got, want = port.center.numpy(), ref.center
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-5
    moved = np.linalg.norm(want - built[0])
    assert moved > 0
    # the center's step itself, against its own size: gradients differ by
    # ~2e-6, so the steps agree to well inside 1e-3
    assert np.linalg.norm(got - want) / moved <= 1e-3
    for key in ("sync_rounds", "messages", "wire_bytes"):
        assert port.counters[key] == ref.counters[key], key


@pytest.mark.parametrize("field,value", [
    ("telemetry", True), ("elastic", True), ("chaos", {"wid": 1}),
    ("topology", costmodel.Topology(2, 2))])
def test_unported_config_raises(field, value):
    """Every feature is ported and accepted where the reference accepts
    it: elastic membership and chaos only on the tcp transport, a topology
    on the thread and tcp planes (the process transport has no pacing of
    its own)."""
    kw = {"algorithm": "sync_easgd", field: value}
    if field == "topology":
        assert runtime.PSConfig(**kw).topology == value
        with pytest.raises(ValueError, match="thread and tcp"):
            runtime.PSConfig(transport="process", **kw)
        return
    if field in ("elastic", "chaos"):
        with pytest.raises(ValueError, match="tcp"):
            runtime.PSConfig(**kw)
        kw["transport"] = "tcp"
    assert getattr(runtime.PSConfig(**kw), field) == value


def test_bad_config_and_device_raise():
    with pytest.raises(ValueError):
        runtime.PSConfig(algorithm="sync_sgd", schedule="nope")
    with pytest.raises(ValueError):
        runtime.PSConfig(algorithm="sync_sgd", bucket_bytes=-1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            runtime.run_ps(problems.NUMPY_MLP, EASGDConfig(),
                           runtime.PSConfig(algorithm="sync_sgd",
                                            total_iters=4))


def test_failing_gradient_surfaces_with_its_cause():
    w0, grad_fn, eval_fn = problems.NUMPY_MLP.build("cpu")

    def bad_grad(w, step, worker):
        if step == 1 and worker == 1:
            raise FloatingPointError("boom")
        return grad_fn(w, step, worker)

    cfg = runtime.PSConfig(algorithm="sync_easgd", n_workers=2,
                           total_iters=8, eval_every_iters=10**9)
    with pytest.raises(RuntimeError, match="ps run failed") as info:
        runtime.run_ps((w0, bad_grad, eval_fn), EASGDConfig(), cfg,
                       device="cpu", join_timeout_s=60)
    assert isinstance(info.value.__cause__, FloatingPointError)


def test_launcher_prints_result_lines():
    out = io.StringIO()
    with redirect_stdout(out):
        results = train.main(["--mode", "ps", "--algorithm", "all-sync",
                              "--ps-workers", "2", "--ps-iters", "8",
                              "--emulate", "none", "--device", "cpu"])
    lines = out.getvalue().splitlines()
    assert [r.algorithm for r in results] == ["sync_sgd", "sync_easgd"]
    assert len(lines) == 2 and all("launches=" in ln for ln in lines)
    assert "[thread/ring@cpu]" in lines[0] and "us/iter" in lines[0]
    assert all(n == 0 for n in kernels.launch_counts().values())

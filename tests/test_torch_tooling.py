"""The port's small tooling names and its two last examples on the CPU:
``utils.timing.time_fn``, ``data.synthetic.teacher_dataset`` and
``ps.zoo.zoo_names`` against the reference's; ``examples/elastic_restart_
torch.py`` (loss continuity across a crash and a rescale to 3 pods) and
``examples/paper_figures_torch.py`` (final errors equal to the reference
engine's on the same seed and problem)."""
import importlib.util
import io
import os
import time
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from repro import ps as ref_ps
from repro.core import async_engine as ref_engine
from repro.core.easgd import EASGDConfig as RefConfig
from repro.data import synthetic as ref_synthetic
from repro.ps import zoo as ref_zoo
from repro_torch.data import synthetic
from repro_torch.ps import zoo
from repro_torch.utils import timing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _example(name):
    path = os.path.join(REPO, "examples", name + ".py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_time_fn_best_of_iters():
    calls = []

    def fn(x):
        calls.append(1)
        time.sleep(0.01 if len(calls) > 2 else 0.05)
        return (torch.ones(2) * x, {"loss": torch.zeros(())})
    t = timing.time_fn(fn, 3.0, iters=4, warmup=2)
    assert len(calls) == 6
    assert 0.01 <= t < 0.05
    assert timing._device_of(([None], {"a": torch.ones(1)})) == \
        torch.device("cpu")
    assert timing._device_of((1, "x")) is None


@pytest.mark.parametrize("kw", [{}, dict(n=300, d_in=16, n_classes=3,
                                         seed=4, temperature=0.5)])
def test_teacher_dataset_equals_the_reference(kw):
    n = kw.pop("n", 128)
    x, y = synthetic.teacher_dataset(n, **kw)
    rx, ry = ref_synthetic.teacher_dataset(n, **kw)
    assert x.dtype == rx.dtype and y.dtype == ry.dtype
    np.testing.assert_array_equal(x, rx)
    np.testing.assert_array_equal(y, ry)


def test_zoo_names_equal_the_reference():
    assert zoo.zoo_names() == ref_zoo.zoo_names()


def test_elastic_restart_example_on_the_cpu():
    out = io.StringIO()
    with redirect_stdout(out):
        losses = _example("elastic_restart_torch").main(
            ["--device", "cpu", "--steps", "2"])
    text = out.getvalue()
    assert "grew to 3 pods" in text and "loss continuity" in text
    assert len(losses["before"]) == len(losses["after"]) == 2
    assert all(np.isfinite(losses["before"] + losses["after"]))
    assert losses["after"][0] < losses["before"][0] + 0.5


def test_paper_figures_example_equals_the_reference_engine():
    """The example's nine runs on the numpy MLP (the problem every PS test
    pins the runtime with) against the reference's PSEngine with the
    example's settings: the same final errors, algorithm by algorithm."""
    mod = _example("paper_figures_torch")
    iters = 200
    out = io.StringIO()
    with redirect_stdout(out):
        mine = mod.main(["--device", "cpu", "--iters", str(iters),
                         "--problem", "numpy-mlp"])
    w0, grad_fn, err_fn = ref_ps.make_numpy_mlp(seed=0)
    ref = ref_engine.PSEngine(
        grad_fn, err_fn, w0, RefConfig(**mod.EASGD),
        ref_engine.SimConfig(n_workers=mod.N_WORKERS,
                             t_compute=mod.T_COMPUTE, seed=0))
    for algo, res in mine.items():
        want = ref.run(algo, total_iters=iters)
        assert res.final_metric == want.final_metric, algo
        assert res.total_time_s == want.total_time_s, algo
    text = out.getvalue()
    assert text.count("ran ") == 9 and "paper claims" in text

"""The port on the card: its CUDA kernels against their plain versions, and
the runtime's card runs against its CPU runs, bit for bit. Every test is
marked ``cuda`` and skips without a GPU.

This file imports only torch, numpy and the port, so it runs on a machine
without JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The oracles are the CPU paths, which tests/test_torch_elastic_update.py
and tests/test_torch_ps.py pin to the reference bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.easgd import EASGDConfig
from repro_torch.kernels import elastic_update as eu
from repro_torch.ps import problems, runtime

ETA, RHO, MU = 0.05, 0.07, 0.9


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _rows(n, p, device):
    rng = np.random.RandomState(n * 10 + p)
    w, g, c, r, v = (torch.from_numpy(rng.randn(n)).to(device)
                     for _ in range(5))
    return {"w": w, "g": g, "c": c, "r": r * p, "v": v}


def _update_both(d, p):
    """Both fused updates on copies of ``d``; returns the outputs."""
    w, c_out = d["w"].clone(), torch.empty_like(d["c"])
    eu.fused_sync_easgd_update(w, d["g"], d["c"], d["r"], p, ETA, RHO,
                               center_out=c_out)
    w_solo = d["w"].clone()
    eu.fused_sync_easgd_update(w_solo, d["g"], d["c"], d["r"], p, ETA, RHO)
    c, v = d["c"].clone(), d["v"].clone()
    eu.fused_sync_sgd_update(c, v, d["r"], p, ETA, MU)
    return [t.cpu() for t in (w, c_out, w_solo, c, v)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,p", [(1188, 3), (4096, 4), (131072 + 777, 3)])
def test_cuda_kernels_equal_cpu_plain_versions(cuda, n, p):
    eu.reset_launch_counts()
    on_card = _update_both(_rows(n, p, cuda), p)
    torch.cuda.synchronize()
    assert eu.launch_counts() == {"fused_sync_easgd_update": 2,
                                  "fused_sync_sgd_update": 1}
    on_cpu = _update_both(_rows(n, p, "cpu"), p)
    for got, want in zip(on_card, on_cpu):
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["sync_easgd", "sync_sgd"])
def test_cuda_run_equals_cpu_run(cuda, algo):
    cfg = runtime.PSConfig(algorithm=algo, n_workers=3, total_iters=36,
                           eval_every_iters=10**9, bucket_bytes=256)
    easgd = EASGDConfig(eta=ETA, rho=RHO, mu=MU)
    eu.reset_launch_counts()
    gpu = runtime.run_ps(problems.NUMPY_MLP, easgd, cfg, device=cuda)
    launched = eu.launch_counts()
    cpu = runtime.run_ps(problems.NUMPY_MLP, easgd, cfg, device="cpu")
    assert torch.equal(gpu.center.cpu(), cpu.center)
    assert torch.equal(gpu.workers.cpu(), cpu.workers)
    assert gpu.counters == cpu.counters
    rounds = 36 // 3
    assert launched == ({"fused_sync_easgd_update": 3 * rounds,
                         "fused_sync_sgd_update": 0} if algo == "sync_easgd"
                        else {"fused_sync_easgd_update": 0,
                              "fused_sync_sgd_update": rounds})

"""The port's fused sync-family updates (``repro_torch.kernels.
elastic_update``) against the reference, bit for bit.

1. The plain versions against the reference's Pallas kernels
   (``repro/kernels/elastic_update.py``), run in interpret mode in a
   subprocess with the no-FMA pin the reference's own kernel test uses.
   ``repro.kernels`` does not import on current jax (``jax.experimental.
   enable_x64`` is gone); the subprocess aliases it to ``jax.enable_x64``
   before the import, changing nothing in the JAX package.
2. The plain versions against ``repro.core.easgd_flat`` in process, and the
   port's ``core.easgd_flat`` against the reference's, rule by rule.
3. The wrappers' checks. The CUDA kernels themselves are held on the card
   by tests/test_torch_cuda.py.
"""
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.core import easgd_flat as ref_flat
from repro_torch.core import easgd_flat
from repro_torch import kernels
from repro_torch.core.easgd import EASGDConfig
from repro_torch.kernels import elastic_update as eu

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")
ETA, RHO, MU = 0.05, 0.07, 0.9
CASES = [(n, p) for n in (1188, 4096, 131072, 131072 + 777)
         for p in (2, 3, 4)]


def _inputs(n: int, p: int) -> dict:
    rng = np.random.RandomState(n * 10 + p)
    w, g, c, r, v = (rng.randn(n) for _ in range(5))
    return {"w": w, "g": g, "c": c, "r": r * p, "v": v}


_REF_SCRIPT = r"""
import sys
import jax
import jax.experimental
jax.experimental.enable_x64 = jax.enable_x64   # shim: name moved in jax
import numpy as np
from repro.kernels.elastic_update import (fused_sync_easgd_update,
                                          fused_sync_sgd_update)
src, dst, eta, rho, mu = sys.argv[1], sys.argv[2], *map(float, sys.argv[3:])
data, out = np.load(src), {}
for key in sorted({k.rsplit("_", 1)[0] for k in data.files}):
    n, p = map(int, key.split("x"))
    d = {k: data[f"{key}_{k}"] for k in "wgcrv"}
    out[f"{key}_w"], out[f"{key}_c"] = fused_sync_easgd_update(
        d["w"], d["g"], d["c"], d["r"], p, eta, rho)
    out[f"{key}_c2"], out[f"{key}_v2"] = fused_sync_sgd_update(
        d["c"], d["v"], d["r"], p, eta, mu)
np.savez(dst, **out)
print("REF-OK")
"""


@pytest.fixture(scope="module")
def pallas_ref(tmp_path_factory):
    """Outputs of the reference Pallas kernels (interpret mode) for every
    case, or the subprocess's error text."""
    tmp = tmp_path_factory.mktemp("pallas")
    src, dst = tmp / "in.npz", tmp / "out.npz"
    np.savez(src, **{f"{n}x{p}_{k}": a for n, p in CASES
                     for k, a in _inputs(n, p).items()})
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=SSE4_2")
    proc = subprocess.run(
        [sys.executable, "-c", _REF_SCRIPT, str(src), str(dst), str(ETA),
         str(RHO), str(MU)], env=env, capture_output=True, text=True,
        timeout=300)
    if proc.returncode != 0 or "REF-OK" not in proc.stdout:
        return SimpleNamespace(error=proc.stderr[-3000:], out=None)
    return SimpleNamespace(error=None, out=np.load(dst))


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def _port_easgd(d, p):
    w, c_out = _t(d["w"]), torch.empty(len(d["w"]), dtype=torch.float64)
    eu.fused_sync_easgd_update(w, _t(d["g"]), _t(d["c"]), _t(d["r"]), p,
                               ETA, RHO, center_out=c_out)
    return w.numpy(), c_out.numpy()


def _port_sgd(d, p):
    c, v = _t(d["c"]), _t(d["v"])
    eu.fused_sync_sgd_update(c, v, _t(d["r"]), p, ETA, MU)
    return c.numpy(), v.numpy()


def _held(pallas_ref):
    assert pallas_ref.error is None, (
        "the reference Pallas kernel no longer runs under the "
        "enable_x64 shim (the easgd_flat half is held separately):\n"
        + pallas_ref.error)
    return pallas_ref.out


@pytest.mark.parametrize("n,p", CASES)
def test_plain_easgd_equals_pallas_kernel(pallas_ref, n, p):
    out = _held(pallas_ref)
    d = _inputs(n, p)
    w, c = _port_easgd(d, p)
    np.testing.assert_array_equal(w, out[f"{n}x{p}_w"])
    if p & (p - 1) == 0:
        np.testing.assert_array_equal(c, out[f"{n}x{p}_c"])
    else:
        # XLA compiles the kernel's R/P as R·(1/P): the same bits as the
        # division (which easgd_flat, the port and the runtime's bitwise
        # pins use) only for a power-of-two P. Hold the kernel to that form.
        mean = d["r"] * (1.0 / p)
        want = d["c"] + (ETA * RHO * p) * (mean - d["c"])
        np.testing.assert_array_equal(out[f"{n}x{p}_c"], want)


@pytest.mark.parametrize("n,p", CASES)
def test_plain_sgd_equals_pallas_kernel(pallas_ref, n, p):
    out = _held(pallas_ref)
    d = _inputs(n, p)
    c, v = _port_sgd(d, p)
    if p & (p - 1) == 0:
        np.testing.assert_array_equal(c, out[f"{n}x{p}_c2"])
        np.testing.assert_array_equal(v, out[f"{n}x{p}_v2"])
    else:
        # …and folds η(R/P) into (η·(1/P))·R
        v_want = MU * d["v"] - (ETA * (1.0 / p)) * d["r"]
        np.testing.assert_array_equal(out[f"{n}x{p}_v2"], v_want)
        np.testing.assert_array_equal(out[f"{n}x{p}_c2"], d["c"] + v_want)


@pytest.mark.parametrize("n,p", CASES)
def test_plain_versions_equal_reference_easgd_flat(n, p):
    """The reference pair the fused kernels replace: worker_step then
    sync_master_easgd on the mean, and sync_master_sgd."""
    d = _inputs(n, p)
    cfg = SimpleNamespace(eta=ETA, rho=RHO, mu=MU, alpha=ETA * RHO)
    w_ref, c_ref = d["w"].copy(), d["c"].copy()
    ref_flat.worker_step("sync_easgd", w_ref, None, d["g"], c_ref, cfg)
    ref_flat.sync_master_easgd(c_ref, d["r"] / p, p, cfg)
    w, c = _port_easgd(d, p)
    np.testing.assert_array_equal(w, w_ref)
    np.testing.assert_array_equal(c, c_ref)
    c2_ref, v2_ref = d["c"].copy(), d["v"].copy()
    ref_flat.sync_master_sgd(c2_ref, v2_ref, d["r"] / p, cfg)
    c2, v2 = _port_sgd(d, p)
    np.testing.assert_array_equal(c2, c2_ref)
    np.testing.assert_array_equal(v2, v2_ref)


@pytest.mark.parametrize("algorithm", [
    "sync_easgd", "sync_sgd", "async_measgd", "async_msgd", "async_sgd"])
def test_easgd_flat_rules_equal_reference(algorithm):
    """worker_step and local_step, in place, bit for bit (every branch)."""
    d = _inputs(4096, 3)
    cfg = EASGDConfig(eta=ETA, rho=RHO, mu=MU)
    for fn, args in (("worker_step", ("w", "v", "g", "c")),
                     ("local_step", ("w", "v", "g"))):
        ref = {k: d[k].copy() for k in "wvgc"}
        getattr(ref_flat, fn)(algorithm, *(ref[k] for k in args), cfg)
        port = {k: _t(d[k]) for k in "wvgc"}
        getattr(easgd_flat, fn)(algorithm, *(port[k] for k in args), cfg)
        for k in "wv":
            np.testing.assert_array_equal(port[k].numpy(), ref[k])


def test_port_sync_masters_equal_reference():
    d = _inputs(131072 + 777, 3)
    cfg = EASGDConfig(eta=ETA, rho=RHO, mu=MU)
    c_ref, v_ref = d["c"].copy(), d["v"].copy()
    ref_flat.sync_master_easgd(c_ref, d["r"] / 3, 3, cfg)
    c = _t(d["c"])
    easgd_flat.sync_master_easgd(c, _t(d["r"]) / 3, 3, cfg)
    np.testing.assert_array_equal(c.numpy(), c_ref)
    c_ref = d["c"].copy()
    ref_flat.sync_master_sgd(c_ref, v_ref, d["r"] / 3, cfg)
    c, v = _t(d["c"]), _t(d["v"])
    easgd_flat.sync_master_sgd(c, v, _t(d["r"]) / 3, cfg)
    np.testing.assert_array_equal(c.numpy(), c_ref)
    np.testing.assert_array_equal(v.numpy(), v_ref)


def test_easgd_without_center_out_updates_only_w():
    d = _inputs(1188, 4)
    w_full, _ = _port_easgd(d, 4)
    w, c = _t(d["w"]), _t(d["c"])
    eu.fused_sync_easgd_update(w, _t(d["g"]), c, _t(d["r"]), 4, ETA, RHO)
    np.testing.assert_array_equal(w.numpy(), w_full)
    np.testing.assert_array_equal(c.numpy(), d["c"])


@pytest.mark.parametrize("bad", ["dtype", "length", "strided", "2d"])
def test_wrappers_reject_bad_rows(bad):
    rows = [torch.zeros(64, dtype=torch.float64) for _ in range(4)]
    rows[1] = {"dtype": rows[1].float(),
               "length": torch.zeros(63, dtype=torch.float64),
               "strided": torch.zeros(128, dtype=torch.float64)[::2],
               "2d": rows[1].view(8, 8)}[bad]
    with pytest.raises((TypeError, ValueError)):
        eu.fused_sync_easgd_update(*rows, 2, ETA, RHO)
    with pytest.raises((TypeError, ValueError)):
        eu.fused_sync_sgd_update(*rows[1:], 2, ETA, MU)


def test_cpu_path_counts_no_launch():
    kernels.reset_launch_counts()
    d = _inputs(1188, 2)
    _port_easgd(d, 2)
    _port_sgd(d, 2)
    assert kernels.launch_counts()["fused_sync_easgd_update"] == 0
    assert kernels.launch_counts()["fused_sync_sgd_update"] == 0

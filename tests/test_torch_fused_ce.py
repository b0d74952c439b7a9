"""The port's fused cross-entropy (``repro_torch.kernels.fused_ce``)
against the reference, on inputs made with numpy from a seed.

1. The plain forward against ``kernels/ref.py`` ``fused_ce_ref`` (loaded
   by file path: ``repro.kernels`` does not import on current jax), and
   the plain backward against ``jax.grad`` of ``Σ_t g_t·fused_ce_ref``.
2. The plain forward against the Pallas ``fused_cross_entropy`` in
   interpret mode, on the cases of tests/test_kernels.py, in a subprocess
   that aliases ``jax.experimental.enable_x64`` to ``jax.enable_x64``
   first (nothing in the JAX package changes).
3. The wrappers' CPU dispatch and checks. The CUDA kernels are held
   against these plain versions on the card by tests/test_torch_cuda.py.

Tolerance 1e-5: both sides compute f32 logits and differ only in the order
of f32 sums.
"""
import importlib.util
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import fused_ce

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")
TOL = 1e-5


def _ref_module():
    spec = importlib.util.spec_from_file_location(
        "repro_kernels_ref", os.path.join(SRC, "repro", "kernels", "ref.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(T, d, V, seed, w_scale=0.1):
    rng = np.random.RandomState(seed)
    h = rng.randn(T, d).astype(np.float32)
    w = (rng.randn(d, V) * w_scale).astype(np.float32)
    t = rng.randint(0, V, size=T).astype(np.int64)
    g = rng.rand(T).astype(np.float32)
    return h, w, t, g


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("T,d,V", [(64, 32, 300), (100, 16, 512),
                                   (32, 64, 1000), (7, 2, 5)])
def test_plain_fwd_bwd_match_ref_and_jax_grad(T, d, V):
    ref = _ref_module()
    h, w, t, g = _inputs(T, d, V, seed=T + V)
    want = ref.fused_ce_ref(jnp.asarray(h), jnp.asarray(w), jnp.asarray(t))
    loss, lse, pred = fused_ce.fused_ce_fwd_ref(
        torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(t))
    _close(loss, want)
    logits = h @ w
    np.testing.assert_array_equal(pred.numpy(), np.argmax(logits, axis=1))
    want_dh, want_dw = jax.grad(
        lambda h, w: jnp.sum(jnp.asarray(g) * ref.fused_ce_ref(
            h, w, jnp.asarray(t))), argnums=(0, 1))(jnp.asarray(h),
                                                    jnp.asarray(w))
    dh, dw = fused_ce.fused_ce_bwd_ref(
        torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(t), lse,
        torch.from_numpy(g))
    _close(dh, want_dh)
    _close(dw, want_dw)


def test_argmax_ties_keep_the_first_index():
    h = torch.ones(3, 2)
    w = torch.tensor([[1.0, 3.0, 3.0, 0.0], [1.0, 0.0, 0.0, 3.0]])
    _, _, pred = fused_ce.fused_ce_fwd(h, w, torch.zeros(3, dtype=torch.long))
    assert pred.tolist() == [1, 1, 1]          # logits 2, 3, 3, 3


def test_autograd_function_matches_the_plain_pair():
    h, w, t, g = _inputs(40, 16, 200, seed=3)
    th = torch.from_numpy(h).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    tt = torch.from_numpy(t)
    kernels.reset_launch_counts()
    loss, pred = fused_ce.FusedCrossEntropy.apply(th, tw, tt)
    (loss * torch.from_numpy(g)).sum().backward()
    want, lse, want_pred = fused_ce.fused_ce_fwd_ref(th.detach(),
                                                     tw.detach(), tt)
    assert torch.equal(loss.detach(), want) and torch.equal(pred, want_pred)
    dh, dw = fused_ce.fused_ce_bwd_ref(th.detach(), tw.detach(), tt, lse,
                                       torch.from_numpy(g))
    assert torch.equal(th.grad, dh) and torch.equal(tw.grad, dw)
    assert all(v == 0 for v in kernels.launch_counts().values())


def test_bf16_gradients_come_back_in_bf16():
    h, w, t, g = _inputs(24, 16, 64, seed=5)
    hb, wb = torch.from_numpy(h).bfloat16(), torch.from_numpy(w).bfloat16()
    loss, lse, _ = fused_ce.fused_ce_fwd(hb, wb, torch.from_numpy(t))
    assert loss.dtype == lse.dtype == torch.float32
    dh, dw = fused_ce.fused_ce_bwd(hb, wb, torch.from_numpy(t), lse,
                                   torch.from_numpy(g))
    assert dh.dtype == dw.dtype == torch.bfloat16
    assert dh.shape == hb.shape and dw.shape == wb.shape


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,V", [(4096, 262144), (4096, 50280), (48, 512),
                                 (100, 300), (130, 100), (1, 1),
                                 (200, 50280), (256, 520)])
def test_vocab_splits_cover_the_vocabulary_once(dtype, T, V):
    """Whole vocab tiles a split, every column in exactly one split, the
    last split ragged only at V; enough blocks to fill 132 SMs when the
    vocabulary allows."""
    rows, tile, target = fused_ce._FWD_PLAN[dtype]
    per, n = fused_ce.vocab_splits(T, V, dtype)
    assert per % tile == 0 and per > 0
    starts = [s * per for s in range(n)]
    ends = [min(V, s + per) for s in starts]
    assert starts[0] == 0 and ends[-1] == V
    assert all(a < b for a, b in zip(starts, ends))
    assert all(e == s for e, s in zip(ends, starts[1:]))
    n_blocks = -(-T // rows) * n
    assert n_blocks >= min(target, -(-T // rows) * -(-V // tile)) * 0.5


@pytest.mark.parametrize("T,V", [(4096, 262144), (4096, 50280), (48, 512),
                                 (100, 300), (1, 1), (65536, 262144),
                                 (4096, 256), (4096, 257)])
def test_vocab_chunks_cover_the_vocabulary(T, V):
    """The bf16 backward's chunk: a power of two of whole vocab tiles,
    buffers within 512 MiB unless one tile exceeds it, and chunks [c·Vc,
    min(V, (c+1)·Vc)) covering V with a ragged last chunk."""
    vc = fused_ce.vocab_chunk(T, V)
    assert vc >= 256 and vc & (vc - 1) == 0
    assert vc == 256 or 2 * T * vc * 2 <= 1 << 29
    assert vc < 2 * V or vc == 256           # never more than V needs
    n = -(-V // vc)
    covered = sum(min(vc, V - c * vc) for c in range(n))
    assert covered == V and 0 < V - (n - 1) * vc <= vc
    assert fused_ce.vocab_chunk(4096, 262144) == 32768
    extra = T * 8 * 4 if V > vc else 0          # the f32 dh sum
    assert fused_ce.bwd_scratch_bytes(T, V, 8) == 2 * T * vc * 2 + extra


def test_wrapper_checks():
    h, w, t = torch.zeros(4, 8), torch.zeros(8, 10), torch.zeros(4).long()
    with pytest.raises(NotImplementedError, match="softcap"):
        fused_ce.fused_ce_fwd(h, w, t, logit_softcap=30.0)
    with pytest.raises(ValueError):
        fused_ce.fused_ce_fwd(h, torch.zeros(7, 10), t)
    with pytest.raises(ValueError):
        fused_ce.fused_ce_fwd(h, w, torch.zeros(5).long())


# ---------------------------------------------------------------------------
# the Pallas kernel in interpret mode
# ---------------------------------------------------------------------------

PALLAS_CASES = [(64, 32, 300, 16, 128), (100, 16, 512, 32, 128),
                (32, 64, 1000, 32, 256)]          # tests/test_kernels.py:93

_PALLAS_SCRIPT = r"""
import sys
import jax
import jax.experimental
jax.experimental.enable_x64 = jax.enable_x64   # shim: name moved in jax
import jax.numpy as jnp
import numpy as np
from repro.kernels import ops
src, dst = sys.argv[1], sys.argv[2]
data, out = np.load(src), {}
for i in range(int(data["n"])):
    bt, bv = (int(x) for x in data[f"{i}_blocks"])
    loss = ops.fused_cross_entropy(
        jnp.asarray(data[f"{i}_h"]), jnp.asarray(data[f"{i}_w"]),
        jnp.asarray(data[f"{i}_t"].astype(np.int32)), block_t=bt,
        block_v=bv, interpret=True)
    out[str(i)] = np.asarray(loss)
np.savez(dst, **out)
print("REF-OK")
"""


@pytest.fixture(scope="module")
def pallas_out(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pallas_ce")
    src, dst = tmp / "in.npz", tmp / "out.npz"
    arrays = {"n": np.array(len(PALLAS_CASES))}
    for i, (T, d, V, bt, bv) in enumerate(PALLAS_CASES):
        h, w, t, _ = _inputs(T, d, V, seed=11 * i)
        arrays.update({f"{i}_h": h, f"{i}_w": w, f"{i}_t": t,
                       f"{i}_blocks": np.array([bt, bv])})
    np.savez(src, **arrays)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _PALLAS_SCRIPT, str(src),
                           str(dst)], env=env, capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0 or "REF-OK" not in proc.stdout:
        return SimpleNamespace(error=proc.stderr[-3000:], out=None)
    return SimpleNamespace(error=None, out=np.load(dst))


@pytest.mark.parametrize("i", range(len(PALLAS_CASES)))
def test_plain_fwd_matches_pallas_kernel(pallas_out, i):
    assert pallas_out.error is None, pallas_out.error
    T, d, V, _, _ = PALLAS_CASES[i]
    h, w, t, _ = _inputs(T, d, V, seed=11 * i)
    loss, _, _ = fused_ce.fused_ce_fwd(torch.from_numpy(h),
                                       torch.from_numpy(w),
                                       torch.from_numpy(t))
    _close(loss, pallas_out.out[str(i)])

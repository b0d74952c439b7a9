"""The port's flash attention (``repro_torch.kernels.flash_attention``)
against the reference, on inputs made with numpy from a seed.

1. The plain forward and backward against ``_flash_fwd_impl`` /
   ``_flash_bwd_impl`` of ``repro.models.attention``, and
   ``flash_attention_train`` against ``jax.grad`` of the reference's.
2. The plain forward against the Pallas ``flash_attention_bhsd`` in
   interpret mode, on the cases of tests/test_kernels.py. ``repro.kernels``
   does not import on current jax (``jax.experimental.enable_x64`` is
   gone), so a subprocess aliases it to ``jax.enable_x64`` first; nothing
   in the JAX package changes.
3. The wrappers' CPU dispatch and checks. The CUDA kernels are held
   against these plain versions on the card by tests/test_torch_cuda.py.

Tolerances: 1e-5 for f32 forward values, 1e-4 for f32 gradients, 2e-2 in
bf16 (those of tests/test_kernels.py). In f32 both sides differ only in
the order of f32 sums; in bf16 a one-ulp difference in a rounded p or ds
moves outputs by ~4e-3 relative.
"""
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ref_attn
from repro_torch import kernels
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import attention

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5, 1e-4),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2, 2e-2)}


def _inputs(B, S, H, KVH, D, seed):
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(B, S, h, D).astype(np.float32)
                   for h in (H, KVH, KVH, H))
    return q, k, v, do


def _both(arrays, dt):
    jdt, tdt = DTYPES[dt][:2]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# (B, S, H, KVH, D, causal, window, q_block, kv_block)
IMPL_CASES = [
    (2, 64, 4, 2, 16, True, 0, 32, 16),
    (1, 96, 4, 2, 32, True, 11, 32, 32),
    (2, 64, 2, 2, 16, False, 0, 16, 32),
    (1, 128, 8, 4, 64, True, 24, 64, 32),
    # head dims the kernels run on the next tile width up
    (2, 64, 4, 2, 24, True, 8, 32, 16),      # reduced gemma3-27b
    (1, 64, 4, 4, 96, True, 0, 32, 32),      # phi3-mini
    (1, 64, 2, 2, 96, False, 0, 16, 32),
]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", IMPL_CASES)
def test_plain_fwd_bwd_match_reference_impl(case, dt):
    B, S, H, KVH, D, causal, window, qb, kb = case
    _, _, tol_f, tol_b = DTYPES[dt]
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _both(
        _inputs(B, S, H, KVH, D, seed=S + D), dt)
    out, lse = ref_attn._flash_fwd_impl(jq, jk, jv, causal, window, qb, kb)
    p_out, p_lse = fa.flash_attention_fwd_ref(tq, tk, tv, causal, window,
                                              qb, kb)
    assert p_out.dtype == tq.dtype and p_lse.dtype == torch.float32
    _close(p_out, out, tol_f)
    _close(p_lse, lse, tol_f)
    want = ref_attn._flash_bwd_impl(jq, jk, jv, out, lse, jdo, causal,
                                    window, qb, kb)
    got = fa.flash_attention_bwd_ref(
        tq, tk, tv, torch.from_numpy(np.array(out.astype(jnp.float32))
                                     ).to(tq.dtype),
        torch.from_numpy(np.array(lse)), tdo, causal, window, qb, kb)
    for g, w in zip(got, want):
        assert g.dtype == tq.dtype
        _close(g, w, tol_b)


@pytest.mark.parametrize("S,window", [(96, 11), (100, 0), (70, 9)])
def test_train_path_gradients_match_jax_grad(S, window):
    """flash_attention_train (padding ragged S to the tiles) against
    jax.grad of the reference's custom-VJP path, f32."""
    q, k, v, do = _inputs(2, S, 4, 2, 16, seed=S)
    kw = dict(causal=True, window=window, q_block=32, kv_block=16)

    def f(q, k, v):
        return jnp.sum(ref_attn.flash_attention_train(q, k, v, **kw) * do)

    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)
    want_out = ref_attn.flash_attention_train(jq, jk, jv, **kw)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    out = attention.flash_attention_train(tq, tk, tv, **kw)
    _close(out.detach(), want_out, 1e-5)
    (out * torch.from_numpy(do)).sum().backward()
    for g, w in zip((tq.grad, tk.grad, tv.grad), want):
        _close(g, w, 1e-4)


def test_rope_matches_reference():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 12, 3, 16).astype(np.float32)
    pos = np.broadcast_to(np.arange(12)[None], (2, 12))
    for theta in (1e4, 1e6):
        want = ref_attn.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
        got = attention.apply_rope(torch.from_numpy(x),
                                   torch.from_numpy(pos.copy()), theta)
        _close(got, want, 1e-5)


# ---------------------------------------------------------------------------
# the Pallas kernel in interpret mode
# ---------------------------------------------------------------------------

PALLAS_CASES = [          # tests/test_kernels.py:16-24
    (2, 64, 4, 2, 32, True, 0, "f32"),
    (1, 100, 2, 2, 16, True, 9, "f32"),
    (2, 128, 4, 1, 64, False, 0, "bf16"),
    (1, 256, 8, 4, 128, True, 64, "f32"),
    (1, 96, 4, 4, 8, True, 0, "bf16"),
]

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
    causal, window, bf16 = (int(x) for x in data[f"{i}_flags"])
    dt = jnp.bfloat16 if bf16 else jnp.float32
    q, k, v = (jnp.asarray(data[f"{i}_{n}"]).astype(dt) for n in "qkv")
    o = ops.flash_attention(q, k, v, causal=bool(causal), window=window,
                            block_q=32, block_k=32, interpret=True)
    out[str(i)] = np.asarray(o.astype(jnp.float32))
np.savez(dst, **out)
print("REF-OK")
"""


@pytest.fixture(scope="module")
def pallas_out(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pallas_attn")
    src, dst = tmp / "in.npz", tmp / "out.npz"
    arrays = {"n": np.array(len(PALLAS_CASES))}
    for i, (B, S, H, KVH, D, causal, window, dt) in enumerate(PALLAS_CASES):
        q, k, v, _ = _inputs(B, S, H, KVH, D, seed=7 * i)
        arrays.update({f"{i}_q": q, f"{i}_k": k, f"{i}_v": v,
                       f"{i}_flags": np.array([causal, window,
                                               dt == "bf16"])})
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
    B, S, H, KVH, D, causal, window, dt = PALLAS_CASES[i]
    _, (tq, tk, tv, _) = _both(_inputs(B, S, H, KVH, D, seed=7 * i), dt)
    out, _ = fa.flash_attention_fwd(tq, tk, tv, causal, window)
    _close(out, pallas_out.out[str(i)], DTYPES[dt][2])


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def test_cpu_wrappers_take_the_plain_versions_and_count_nothing():
    _, (q, k, v, do) = _both(_inputs(1, 40, 4, 2, 16, seed=1), "f32")
    kernels.reset_launch_counts()
    out, lse = fa.flash_attention_fwd(q, k, v, True, 7, 16, 16)
    want = fa.flash_attention_fwd_ref(q, k, v, True, 7, 16, 16)
    assert torch.equal(out, want[0]) and torch.equal(lse, want[1])
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, True, 7, 16, 16)
    ref = fa.flash_attention_bwd_ref(q, k, v, out, lse, do, True, 7, 16, 16)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert all(v == 0 for v in kernels.launch_counts().values())


def test_wrapper_checks():
    q = torch.zeros(1, 8, 4, 16)
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(q, torch.zeros(1, 8, 3, 16),
                               torch.zeros(1, 8, 3, 16))
    # v may take its own head dim (MLA), not its own leading dims
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(q, torch.zeros(1, 8, 2, 16),
                               torch.zeros(1, 8, 1, 8))
    out, _ = fa.flash_attention_fwd(q, torch.zeros(1, 8, 2, 16),
                                    torch.zeros(1, 8, 2, 8))
    assert out.shape == (1, 8, 4, 8)
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(q, torch.zeros(1, 8, 2, 16,
                                              device="meta"),
                               torch.zeros(1, 8, 2, 16, device="meta"))


def test_kernel_checks_take_the_padded_head_dims():
    """D 24 and 96 run on the 32- and 128-column tiles; other dims that are
    no instantiation are refused (``_check_cuda`` reads no device)."""
    for D, dt in ((24, torch.bfloat16), (96, torch.bfloat16),
                  (24, torch.float32), (96, torch.float32)):
        k = torch.zeros(1, 8, 2, D, dtype=dt)
        assert fa._check_cuda(k, k, k) == (dt == torch.bfloat16)
    for D in (8, 48, 80, 192):
        k = torch.zeros(1, 8, 2, D)
        with pytest.raises(ValueError, match="head_dim"):
            fa._check_cuda(k, k, k)


def test_kernel_checks_route_by_dtype_and_refuse_unaligned_bf16():
    """What ``_check_cuda`` takes (it reads no device): bf16 goes to the
    tensor cores only from 16-byte-aligned addresses; f32 needs no more
    than its own alignment."""
    k = torch.zeros(1, 8, 2, 16, dtype=torch.bfloat16)
    assert fa._check_cuda(k, k, k) == 1
    off = torch.zeros(8 * 2 * 16 + 8, dtype=torch.bfloat16)
    off = off[1 + (-off.data_ptr() // 2) % 8:][:8 * 2 * 16].view(1, 8, 2, 16)
    assert off.data_ptr() % 16 == 2
    with pytest.raises(ValueError, match="tensor cores"):
        fa._check_cuda(off, k, k)
    with pytest.raises(ValueError, match="tensor cores"):
        fa._check_cuda(k, k, k, off)
    f = torch.zeros(8 * 2 * 16 + 4)
    f = f[1 + (-f.data_ptr() // 4) % 4:][:8 * 2 * 16].view(1, 8, 2, 16)
    assert f.data_ptr() % 16 == 4
    assert fa._check_cuda(f, f, f) == 0

"""The port's SSD intra-chunk block (``repro_torch.kernels.ssd_chunk``)
against the reference, on inputs made with numpy from a seed.

1. The plain forward against ``kernels/ref.py`` ``ssd_intra_ref`` and the
   Pallas ``ssd_intra_chunk`` in interpret mode, on the cases of
   tests/test_kernels.py. ``repro.kernels`` does not import on current jax
   (``jax.experimental.enable_x64`` is gone), so both files are loaded by
   path; neither needs an edit.
2. The plain backward against ``jax.vjp`` of ``ssd_intra_ref`` on the
   layout the model uses (b and c shared by the heads of a batch row, so
   db and dc sum over the heads), da included.
3. A chunk whose cumulative decay falls below −88: finite outputs equal to
   the reference; the backward against autograd of the plain forward in
   f64 (the reference's own gradient is NaN there: its exponent above the
   diagonal is inf before the mask, and inf·0 is NaN).
4. The wrappers' CPU dispatch and checks. The CUDA kernels are held
   against these plain versions on the card by tests/test_torch_cuda.py.
5. The kernels' precision route, emulated in torch: every product as
   three TF32 products (big·big + big·small + small·big, each operand
   split by round-to-nearest), held against the f64 plain version within
   the f32 limits, where one TF32 product misses them.

Tolerances, by the relative norm ‖port − ref‖ / ‖ref‖: 1e-5 forward and
1e-4 backward, the f32 limits of tests/test_kernels.py. Both sides are f32
and differ only in the order of their sums.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import ssd_chunk

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")
TOL_FWD, TOL_BWD = 1e-5, 1e-4


def _load(rel):
    path = os.path.join(SRC, "repro", "kernels", rel)
    spec = importlib.util.spec_from_file_location(
        f"_ref_{rel[:-3]}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load("ref.py")
PALLAS = _load("ssd_chunk.py")


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _inputs(B, H, S, P, N, seed, decay=None, scale=1.0):
    """a (B·H, S) ≤ 0, x (B·H, S, P), b and c (B, S, N), dy like x."""
    rng = np.random.RandomState(seed)
    if decay is None:
        a = -scale * np.log1p(np.exp(rng.randn(B * H, S)))   # −softplus
    else:
        a = -decay * (0.5 + rng.rand(B * H, S))
    x, dy = (rng.randn(B * H, S, P) for _ in range(2))
    b, c = (rng.randn(B, S, N) for _ in range(2))
    return [t.astype(np.float32) for t in (a, x, b, c, dy)]


def _per_head(t, H):
    """(B, S, N) -> (B·H, S, N): the Pallas kernel's pre-broadcast rows."""
    return jnp.repeat(jnp.asarray(t), H, axis=0)


# (B, H, S, P, N, L, scale of a): the cases of tests/test_kernels.py
# (BH, S, P, N, L) with BH split into batch rows and heads, then mamba2's
# reduced shapes (S 24 padded to 32) and a full-width chunk with several
# heads, its decay scaled so that the cumsum stays above −88, where the
# reference's gradient is finite
CASES = [
    (2, 2, 128, 32, 64, 32, 1.0),
    (1, 2, 64, 16, 16, 16, 1.0),
    (1, 1, 256, 64, 128, 64, 1.0),
    (2, 8, 32, 16, 16, 16, 1.0),
    (1, 3, 256, 64, 128, 256, 0.25),
]


@pytest.mark.parametrize("case", CASES)
def test_plain_forward_matches_ssd_intra_ref(case):
    B, H, S, P, N, L, scale = case
    a, x, b, c, _ = _inputs(B, H, S, P, N, seed=S + P, scale=scale)
    want = REF.ssd_intra_ref(jnp.asarray(a), jnp.asarray(x),
                             _per_head(b, H), _per_head(c, H), chunk=L)
    got = ssd_chunk.ssd_intra_fwd_ref(*map(torch.from_numpy, (a, x, b, c)),
                                      L)
    assert got.dtype == torch.float32 and got.shape == (B * H, S, P)
    assert _rel(got.numpy(), want) <= TOL_FWD


@pytest.mark.parametrize("case", CASES[:3])
def test_plain_forward_matches_pallas_kernel_interpret(case):
    B, H, S, P, N, L, scale = case
    a, x, b, c, _ = _inputs(B, H, S, P, N, seed=S + P, scale=scale)
    want = PALLAS.ssd_intra_chunk(jnp.asarray(a), jnp.asarray(x),
                                  _per_head(b, H), _per_head(c, H), chunk=L,
                                  interpret=True)
    got = ssd_chunk.ssd_intra_fwd(*map(torch.from_numpy, (a, x, b, c)), L)
    assert _rel(got.numpy(), want) <= TOL_FWD


def _ref_vjp(a, x, b, c, dy, H, L):
    def f(a_, x_, b_, c_):
        return REF.ssd_intra_ref(a_, x_, jnp.repeat(b_, H, axis=0),
                                 jnp.repeat(c_, H, axis=0), chunk=L)

    _, vjp = jax.vjp(f, *map(jnp.asarray, (a, x, b, c)))
    da, dx, db, dc = vjp(jnp.asarray(dy))
    return dx, db, dc, da


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_matches_jax_vjp(case):
    B, H, S, P, N, L, scale = case
    a, x, b, c, dy = _inputs(B, H, S, P, N, seed=S + N, scale=scale)
    want = _ref_vjp(a, x, b, c, dy, H, L)
    got = ssd_chunk.ssd_intra_bwd(*map(torch.from_numpy, (a, x, b, c, dy)),
                                  L)
    for name, g, w in zip(("dx", "db", "dc", "da"), got, want):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        assert _rel(g.numpy(), w) <= TOL_BWD, name


def test_autograd_function_gives_the_plain_gradients():
    B, H, S, P, N, L, _ = CASES[3]
    a, x, b, c, dy = (torch.from_numpy(t) for t in
                      _inputs(B, H, S, P, N, seed=5))
    leaves = [t.clone().requires_grad_(True) for t in (a, x, b, c)]
    y = ssd_chunk.SSDIntraChunk.apply(*leaves, L)
    y.backward(dy)
    dx, db, dc, da = ssd_chunk.ssd_intra_bwd(a, x, b, c, dy, L)
    for leaf, want in zip(leaves, (da, dx, db, dc)):
        assert torch.equal(leaf.grad, want)
    assert torch.equal(y.detach(), ssd_chunk.ssd_intra_fwd(a, x, b, c, L))


def test_deep_decay_is_finite_and_matches():
    """Mean a_t of −1 over L = 128: the in-chunk cumsum reaches about
    −128, where exp(cum_i)·exp(−cum_j) would overflow."""
    B, H, S, P, N, L = 1, 2, 256, 16, 16, 128
    a, x, b, c, dy = _inputs(B, H, S, P, N, seed=9, decay=1.0)
    assert float(np.cumsum(a[:, :L], axis=1).min()) < -88
    want = REF.ssd_intra_ref(jnp.asarray(a), jnp.asarray(x),
                             _per_head(b, H), _per_head(c, H), chunk=L)
    ta, tx, tb, tc, tdy = map(torch.from_numpy, (a, x, b, c, dy))
    y = ssd_chunk.ssd_intra_fwd(ta, tx, tb, tc, L)
    assert bool(torch.isfinite(y).all())
    assert _rel(y.numpy(), want) <= TOL_FWD
    grads = ssd_chunk.ssd_intra_bwd(ta, tx, tb, tc, tdy, L)
    leaves = [t.double().requires_grad_(True) for t in (ta, tx, tb, tc)]
    ssd_chunk.ssd_intra_fwd_ref(*leaves, L).backward(tdy.double())
    for name, g, leaf in zip(("dx", "db", "dc", "da"), grads,
                             (leaves[1], leaves[2], leaves[3], leaves[0])):
        assert bool(torch.isfinite(g).all()), name
        assert _rel(g.numpy(), leaf.grad.numpy()) <= TOL_BWD, name


def test_wrappers_check_shapes_and_count_no_cpu_launch():
    a, x, b, c, dy = map(torch.from_numpy, _inputs(2, 2, 32, 8, 4, seed=1))
    kernels.reset_launch_counts()
    ssd_chunk.ssd_intra_fwd(a, x, b, c, 16)
    ssd_chunk.ssd_intra_bwd(a, x, b, c, dy, 16)
    assert kernels.launch_counts()["ssd_intra_fwd"] == 0
    assert kernels.launch_counts()["ssd_intra_bwd"] == 0
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd_chunk.ssd_intra_fwd(a, x, b, c, 12)
    with pytest.raises(ValueError, match="do not pair"):
        ssd_chunk.ssd_intra_fwd(a[:3], x[:3], b, c, 16)
    with pytest.raises(ValueError):
        ssd_chunk.ssd_intra_bwd(a, x, b, c, dy[:, :16], 16)
    assert ssd_chunk.chunk_len(24, 256) == 24


def test_head_group_fills_one_wave_of_blocks():
    """mamba2-780m's full width: 32 blocks without groups, 132 SMs."""
    assert ssd_chunk.head_group(48, 32, 132) == 12
    assert ssd_chunk.head_group(5, 32, 132) == 2      # groups of 2, 2, 1
    assert ssd_chunk.head_group(8, 4, 132) == 1
    assert ssd_chunk.head_group(48, 200, 132) == 32   # at most 32 a block


# ---------------------------------------------------------------------------
# the kernels' precision route, emulated
# ---------------------------------------------------------------------------

def _tf32(t):
    """Round f32 to TF32 (10 stored mantissa bits), to nearest with ties
    away from zero, by integer ops on the int32 view: what the kernels'
    split does before the tensor core reads an operand."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm(p, q, route):
    """p @ q in f32 by ``route``: "f32"; "tf32", one product of the rounded
    operands; "3xtf32", the kernels' big·small + small·big + big·big. The
    products of two TF32 values are exact in f32, as in the tensor core."""
    if route == "f32":
        return p @ q
    pb, qb = _tf32(p), _tf32(q)
    if route == "tf32":
        return pb @ qb
    ps, qs = _tf32(p - pb), _tf32(q - qb)
    return (ps @ qb + pb @ qs) + pb @ qb


def _emulated(a, x, b, c, dy, L, route):
    """y, dx, db, dc and da of the SSD block in f32, every product by
    ``route``, in the kernels' order of operations."""
    Bsz, S, N = b.shape
    H, P, nc = x.shape[0] // Bsz, x.shape[2], S // L
    a_ = a.reshape(Bsz, H, nc, L)
    x_, dy_ = (t.reshape(Bsz, H, nc, L, P) for t in (x, dy))
    b_, c_ = (t.reshape(Bsz, 1, nc, L, N) for t in (b, c))
    cum = torch.cumsum(a_, dim=-1)
    mask = torch.ones((L, L), dtype=torch.bool).tril()
    dec = torch.exp((cum[..., :, None] - cum[..., None, :])
                    .masked_fill(~mask, -torch.inf))
    g = _mm(c_, b_.transpose(-1, -2), route)
    m = g * dec
    y = _mm(m, x_, route)
    dx = _mm(m.transpose(-1, -2), dy_, route)
    dgh = _mm(dy_, x_.transpose(-1, -2), route) * dec
    dg = dgh.sum(dim=1, keepdim=True)
    dc = _mm(dg, b_, route)
    db = _mm(dg.transpose(-1, -2), c_, route)
    q = dgh * g
    dcum = q.sum(dim=-1) - q.sum(dim=-2)
    da = torch.flip(torch.cumsum(torch.flip(dcum, (-1,)), dim=-1), (-1,))
    return (y.reshape(x.shape), dx.reshape(x.shape), db.reshape(b.shape),
            dc.reshape(c.shape), da.reshape(a.shape))


@pytest.mark.parametrize("B,H,S,P,N,L,scale", [
    (1, 3, 512, 64, 128, 256, 1.0),     # mamba2-780m's full-width chunk
    (1, 2, 256, 16, 16, 128, 2.0),      # the cumsum far below -88
])
def test_three_tf32_products_keep_the_f32_limits(B, H, S, P, N, L, scale):
    """Against the f64 plain version: 3xTF32 within y 1e-5 and dx, db, dc,
    da 1e-4, as plain f32 is; one TF32 product outside every limit."""
    ins = [torch.from_numpy(t) for t in
           _inputs(B, H, S, P, N, seed=L + P, scale=scale)]
    want = (ssd_chunk.ssd_intra_fwd_ref(*(t.double() for t in ins[:4]), L),
            *ssd_chunk.ssd_intra_bwd_ref(*(t.double() for t in ins), L))
    limits = (TOL_FWD,) + (TOL_BWD,) * 4
    for route in ("f32", "3xtf32", "tf32"):
        got = _emulated(*ins, L, route)
        for name, gv, wv, lim in zip(("y", "dx", "db", "dc", "da"), got,
                                     want, limits):
            rel = _rel(gv.numpy(), wv.numpy())
            if route == "tf32":
                assert rel > lim, (route, name, rel)
            else:
                assert rel <= lim, (route, name, rel)

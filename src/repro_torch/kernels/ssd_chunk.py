"""Mamba-2 SSD intra-chunk block, forward and backward: CUDA kernels, their
plain versions, their launch counters and the autograd function that joins
them (the port of ``repro/kernels/ssd_chunk.py`` ``ssd_intra_chunk``, and
of the gradient XLA takes of ``_ssd_chunked``'s intra-chunk term,
``repro/models/ssm.py:113-119``).

    ssd_intra_fwd(a, x, b, c, chunk)         -> y
    ssd_intra_bwd(a, x, b, c, dy, chunk)     -> dx, db, dc, da

a is the log-decay ``(B·H, S)`` (≤ 0), x ``(B·H, S, P)``, and b, c
``(B, S, N)``: one group, shared by the H heads of a batch row, as the
reference model has it (``models/ssm.py:79``); head ``bh`` reads row
``bh // H``, and nothing is broadcast per head. Per chunk of
``L = min(chunk, S)`` (``S % L == 0``)::

    Y_i = Σ_{j≤i} (C_i·B_j) · exp(cum_i − cum_j) · X_j

with ``cum`` the in-chunk cumsum of a. Everything is f32 (the plain
versions compute f64 inputs in f64); the outputs come back in the inputs'
dtypes. ``db`` and ``dc`` sum over the heads.

A wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernels of ``csrc/ssd_chunk.cu`` (f32, contiguous,
chunks up to 256 and head dims up to 64) or raises. Each wrapper call that
launches adds one to its ``launches``. The kernels run every product on the
tensor cores as three TF32 products (``csrc/ssd_chunk.cu`` says how).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import costmodel
from repro_torch.kernels import _build
from repro_torch.utils import opcount_hook

TILE = 64                       # the kernels' tile edge (csrc/ssd_chunk.cu)
MAX_CHUNK, MAX_HEAD_DIM, MAX_HEADS_A_BLOCK = 4 * TILE, TILE, 32
_c_ptr, _c_int = ctypes.c_void_p, ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_chunk")
    if lib.repro_ssd_fwd.argtypes is None:
        lib.repro_ssd_fwd.argtypes = [_c_ptr] * 5 + [_c_int] * 7 + [_c_ptr]
        lib.repro_ssd_fwd.restype = ctypes.c_int
        lib.repro_ssd_bwd.argtypes = [_c_ptr] * 12 + [_c_int] * 7 + [_c_ptr]
        lib.repro_ssd_bwd.restype = ctypes.c_int
        lib.repro_ssd_smem.argtypes = [_c_int] * 3
        lib.repro_ssd_smem.restype = ctypes.c_long
    return lib


def head_group(H: int, base: int, slots: int) -> int:
    """Heads per block: ``base`` blocks each get ``H`` split into as many
    groups as fill ``slots`` (one wave of resident blocks), at least one
    head a group and at most ``MAX_HEADS_A_BLOCK``."""
    groups = max(1, min(H, slots // max(base, 1)))
    return min(-(-H // groups), MAX_HEADS_A_BLOCK)


def _heads_a_block(backward: bool, B, H, S, L, dev) -> int:
    """``head_group`` for this card, one block on an SM; fewer heads where
    the cumsum rows would not fit its shared memory (``repro_ssd_smem``
    gives 0)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    base = B * (S // L) * ((-(-L // TILE) + 1) // 2)
    hg = head_group(H, base, sms)
    while hg > 1 and not _lib().repro_ssd_smem(int(backward), L, hg):
        hg -= 1
    return hg


def chunk_len(S: int, chunk: int) -> int:
    """``L = min(chunk, S)``; raises unless it divides S."""
    L = min(chunk, S)
    if L <= 0 or S % L:
        raise ValueError(f"S = {S} is not a multiple of the chunk {L}")
    return L


def _dims(a, x, b, c, chunk):
    """-> (B, H, S, L, P, N) after checking shapes and devices."""
    if a.dim() != 2 or x.dim() != 3 or b.dim() != 3 or c.shape != b.shape:
        raise ValueError(f"expected a (BH, S), x (BH, S, P), b and c "
                         f"(B, S, N); got {tuple(a.shape)}, "
                         f"{tuple(x.shape)}, {tuple(b.shape)}, "
                         f"{tuple(c.shape)}")
    BH, S = a.shape
    Bsz, N = b.shape[0], b.shape[2]
    if x.shape[:2] != (BH, S) or b.shape[1] != S or Bsz == 0 or BH % Bsz:
        raise ValueError(f"a {tuple(a.shape)}, x {tuple(x.shape)} and b "
                         f"{tuple(b.shape)} do not pair (BH a multiple of B)")
    for t in (x, b, c):
        if t.device != a.device:
            raise ValueError(f"tensors on {a.device} and {t.device}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {a.device}")
    return Bsz, BH // Bsz, S, chunk_len(S, chunk), x.shape[2], N


def _check_cuda(L, P, *tensors) -> None:
    if L > MAX_CHUNK or P > MAX_HEAD_DIM:
        raise ValueError(f"the SSD kernels take chunks up to {MAX_CHUNK} "
                         f"and head dims up to {MAX_HEAD_DIM}; got L {L}, "
                         f"P {P}")
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"the SSD kernels take float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the SSD kernels need contiguous tensors")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _chunks(a, x, b, c, B, H, L):
    """Per chunk, in f32 (f64 for f64 inputs): x (B,H,nc,L,P), b, c
    (B,nc,L,N), and the decay exp(cum_i − cum_j) (B,H,nc,L,L), formed only
    where i ≥ j (0 above the diagonal)."""
    S = a.shape[1]
    nc = S // L
    dt = torch.promote_types(x.dtype, torch.float32)
    a_ = a.reshape(B, H, nc, L).to(dt)
    x_ = x.reshape(B, H, nc, L, -1).to(dt)
    b_ = b.reshape(B, nc, L, -1).to(dt)
    c_ = c.reshape(B, nc, L, -1).to(dt)
    cum = torch.cumsum(a_, dim=-1)
    mask = torch.ones((L, L), dtype=torch.bool, device=a.device).tril()
    seg = (cum[..., :, None] - cum[..., None, :]).masked_fill(~mask,
                                                              -torch.inf)
    return x_, b_, c_, torch.exp(seg)


def ssd_intra_fwd_ref(a, x, b, c, chunk: int):
    """Plain version of ``ssd_intra_fwd`` (``kernels/ref.py``
    ``ssd_intra_ref`` with b and c shared by the heads): G = C·Bᵀ once per
    chunk, ``M = G ∘ exp(segsum a)`` on and below the diagonal, Y = M·X."""
    B, H, S, L, P, _ = _dims(a, x, b, c, chunk)
    x_, b_, c_, dec = _chunks(a, x, b, c, B, H, L)
    g = torch.einsum("bcln,bcmn->bclm", c_, b_)
    m = g[:, None] * dec
    y = torch.einsum("bhclm,bhcmp->bhclp", m, x_)
    return y.reshape(B * H, S, P).to(x.dtype)


def ssd_intra_bwd_ref(a, x, b, c, dy, chunk: int):
    """Plain version of ``ssd_intra_bwd``: the analytic gradient of
    ``Σ dy·y``. ``dX = Mᵀ·dY``; ``dM = dY·Xᵀ`` (i ≥ j); ``dG`` is dM times
    the decay, summed over the heads, so ``dC = dG·B`` and ``dB = dGᵀ·C``
    take one product per chunk; each ``Q_ij = dM_ij·M_ij`` adds to
    ``dcum_i`` and subtracts from ``dcum_j``, and ``da`` is the reverse
    cumsum of ``dcum`` within the chunk."""
    B, H, S, L, P, N = _dims(a, x, b, c, chunk)
    if dy.shape != x.shape or dy.device != x.device:
        raise ValueError(f"dy {tuple(dy.shape)} does not match x "
                         f"{tuple(x.shape)}")
    x_, b_, c_, dec = _chunks(a, x, b, c, B, H, L)
    nc = S // L
    dy_ = dy.reshape(B, H, nc, L, P).to(x_.dtype)
    g = torch.einsum("bcln,bcmn->bclm", c_, b_)
    m = g[:, None] * dec
    dx = torch.einsum("bhclm,bhclp->bhcmp", m, dy_)
    dgh = torch.einsum("bhclp,bhcmp->bhclm", dy_, x_) * dec
    dg = dgh.sum(dim=1)
    dc = torch.einsum("bclm,bcmn->bcln", dg, b_)
    db = torch.einsum("bclm,bcln->bcmn", dg, c_)
    q = dgh * g[:, None]
    dcum = q.sum(dim=-1) - q.sum(dim=-2)
    da = torch.flip(torch.cumsum(torch.flip(dcum, (-1,)), dim=-1), (-1,))
    return (dx.reshape(B * H, S, P).to(x.dtype),
            db.reshape(B, S, N).to(b.dtype), dc.reshape(B, S, N).to(c.dtype),
            da.reshape(B * H, S).to(a.dtype))


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------

def _sizes(a, x, b, chunk) -> tuple:
    """(B, H, S, P, N, L) of a call, for ``costmodel.ssd_*_work``."""
    BH, S = a.shape
    B = b.shape[0]
    return B, BH // B, S, x.shape[2], b.shape[2], min(chunk, S)


def _fwd_work(a, x, b, c, chunk) -> tuple:
    return costmodel.ssd_fwd_work(*_sizes(a, x, b, chunk))


def _bwd_work(a, x, b, c, dy, chunk) -> tuple:
    return costmodel.ssd_bwd_work(*_sizes(a, x, b, chunk))


def _fwd_outputs(a, x, *_, **__):
    return torch.empty_like(x)


def _bwd_outputs(a, x, b, c, *_, **__) -> tuple:
    return tuple(torch.empty_like(t) for t in (x, b, c, a))


@opcount_hook.kernel_region(_fwd_work, _fwd_outputs)
def ssd_intra_fwd(a, x, b, c, chunk: int):
    """Intra-chunk output ``y`` (B·H, S, P)."""
    B, H, S, L, P, N = _dims(a, x, b, c, chunk)
    if a.device.type == "cpu":
        return ssd_intra_fwd_ref(a, x, b, c, chunk)
    _check_cuda(L, P, a, x, b, c)
    y = torch.empty_like(x)
    if y.numel() == 0 or N == 0:
        return y.zero_()
    dev = a.device
    with torch.cuda.device(dev):
        hg = _heads_a_block(False, B, H, S, L, dev)
        rc = _lib().repro_ssd_fwd(
            a.data_ptr(), x.data_ptr(), b.data_ptr(), c.data_ptr(),
            y.data_ptr(), B, H, S, L, P, N, hg, _build.stream_of(a))
    _build.check_rc(rc, "ssd_intra_fwd")
    _build.count_launch(ssd_intra_fwd)
    return y


ssd_intra_fwd.launches = 0


@opcount_hook.kernel_region(_bwd_work, _bwd_outputs)
def ssd_intra_bwd(a, x, b, c, dy, chunk: int):
    """Gradients of ``Σ dy·y`` -> ``(dx, db, dc, da)``; db and dc sum the
    H heads in a fixed order, without atomics."""
    B, H, S, L, P, N = _dims(a, x, b, c, chunk)
    if dy.shape != x.shape or dy.device != x.device:
        raise ValueError(f"dy {tuple(dy.shape)} does not match x "
                         f"{tuple(x.shape)}")
    if a.device.type == "cpu":
        return ssd_intra_bwd_ref(a, x, b, c, dy, chunk)
    _check_cuda(L, P, a, x, b, c, dy)
    dx, db, dc, da = (torch.empty_like(t) for t in (x, b, c, a))
    if x.numel() == 0 or N == 0:
        return dx.zero_(), db.zero_(), dc.zero_(), da.zero_()
    dev = a.device
    nc, nt = S // L, -(-L // TILE)
    with torch.cuda.device(dev):
        hg = _heads_a_block(True, B, H, S, L, dev)
        f32 = {"dtype": torch.float32, "device": dev}
        # scratch: each head group's dG sum, the row sums of Q per column
        # tile and its column sums
        dgp = torch.empty((B, nc, -(-H // hg), nt * TILE, nt * TILE), **f32)
        rpart = torch.empty((B * H, nc, nt, L), **f32)
        cpart = torch.empty((B * H, nc, L), **f32)
        rc = _lib().repro_ssd_bwd(
            a.data_ptr(), x.data_ptr(), b.data_ptr(), c.data_ptr(),
            dy.data_ptr(), dx.data_ptr(), db.data_ptr(), dc.data_ptr(),
            da.data_ptr(), dgp.data_ptr(), rpart.data_ptr(),
            cpart.data_ptr(), B, H, S, L, P, N, hg, _build.stream_of(a))
    _build.check_rc(rc, "ssd_intra_bwd")
    _build.count_launch(ssd_intra_bwd)
    return dx, db, dc, da


ssd_intra_bwd.launches = 0


class SSDIntraChunk(torch.autograd.Function):
    """``y = ssd_intra(a, x, b, c)`` whose forward and backward are the
    wrappers above (the kernels on the card, the plain versions on the
    CPU); the backward reads the saved inputs and recomputes G and the
    decay, so no (L, L) tensor outlives a call."""

    @staticmethod
    def forward(ctx, a, x, b, c, chunk):
        y = ssd_intra_fwd(a, x, b, c, chunk)
        ctx.save_for_backward(a, x, b, c)
        ctx.chunk = chunk
        return y

    @staticmethod
    def backward(ctx, dy):
        a, x, b, c = ctx.saved_tensors
        dx, db, dc, da = ssd_intra_bwd(a, x, b, c, dy.contiguous(),
                                       ctx.chunk)
        return da, dx, db, dc, None

"""Flash attention, forward and backward: CUDA kernels, their plain
versions, their launch counters and the autograd function that joins them
(the port of ``repro/kernels/flash_attention.py`` ``flash_attention_bhsd``
and of the training path's ``_flash_fwd_impl`` / ``_flash_bwd_impl`` in
``repro/models/attention.py``).

    flash_attention_fwd(q, k, v)                 -> out, lse
    flash_attention_bwd(q, k, v, out, lse, dout) -> dq, dk, dv

q is ``(B, S, H, D)``, k ``(B, S, KVH, D)`` and v ``(B, S, KVH, Dv)``, where
Dv may differ from D (MLA: D 192, Dv 128); out and dout are ``(B, S, H,
Dv)``, and the scale is ``1/√D``. Head h reads KV head ``h // (H /
KVH)``. Masks: ``causal`` and a sliding ``window`` (0 = none).
Scores, softmax statistics and accumulators are f32; ``p`` is rounded to
v's dtype before ``p·V`` and ``ds`` to k's / q's dtype before ``ds·K`` /
``dsᵀ·Q``, as the reference's training path rounds them. ``lse`` is
``(B, S, H)`` f32; gradients come back in the inputs' dtype.

A wrapper takes the plain version only for tensors on the CPU. For CUDA
tensors it launches the kernels of ``csrc/flash_attention.cu`` on the
current stream or raises: there is no fallback. The route follows the
dtype alone, never a failure: bf16 runs on the tensor cores (``wgmma`` for
the forward and the backward's dQ pass, fed by TMA rings of K / V tiles;
``mma.sync`` for the dK/dV pass, fed by a ``cp.async`` ring), which need
every bf16 base address 16-byte aligned; f32 runs on the CUDA cores. The
kernels take the ``(D, Dv)`` pairs of ``HEAD_DIM_PAIRS`` and raise on any
other. Head dims 24, 96 and 192 run on the 32-, 128- and 256-column tiles
(the ``.cu`` dispatch's choice): the kernels take the true D and Dv, read
zeros past them and write nothing there; no tensor is padded. Each
wrapper call that launches adds one to the wrapper's ``launches``.

The plain versions are eager ports of the reference's tiled loops (q tiles
of ``q_block``, kv tiles of ``kv_block``, padded to tile multiples), so on
the CPU they round ``p`` against the same running maxima as the reference.
The kernels tile on their own and mask the ragged tails.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

NEG_INF = -1e30
# the head dims the kernels take with Dv == D: 24 and 96 run on the next
# instantiation up, the kernels zeroing the columns past D in every load
# and skipping them in every store
HEAD_DIMS = (16, 24, 32, 64, 96, 128, 256)
# the (D, Dv) pairs: every D of HEAD_DIMS with itself, and MLA's D 192 /
# Dv 128 (full width, on the 256- and 128-column tiles) and 24 / 16 (the
# reduced deepseek-v2, on the 32- and 16-column tiles)
HEAD_DIM_PAIRS = tuple((d, d) for d in HEAD_DIMS) + ((192, 128), (24, 16))
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_c_ptr, _c_int, _c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if lib.repro_flash_fwd.argtypes is None:
        lib.repro_flash_fwd.argtypes = (
            [_c_ptr] * 5 + [_c_int] * 8 + [_c_float, _c_int, _c_ptr])
        lib.repro_flash_fwd.restype = ctypes.c_int
        lib.repro_flash_bwd.argtypes = (
            [_c_ptr] * 10 + [_c_int] * 8 + [_c_float, _c_int, _c_ptr])
        lib.repro_flash_bwd.restype = ctypes.c_int
    return lib


def _tile_mask(q_pos, kv_pos, causal: bool, window: int):
    """(qb, kb) boolean mask tile from absolute positions."""
    m = torch.ones((q_pos.shape[0], kv_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= q_pos[:, None] >= kv_pos[None, :]
    if window:
        m &= q_pos[:, None] - kv_pos[None, :] < window
    return m


def _check(q, k, v, *more) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 \
            or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"expected q (B,S,H,D), k (B,S,KVH,D) and v "
                         f"(B,S,KVH,Dv); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         f"pair (H must be a multiple of KVH)")
    for t in (k, v) + more:
        if t.device != q.device:
            raise ValueError(f"tensors on {q.device} and {t.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")


def _check_cuda(q, k, v, *tensors) -> int:
    """What the kernels take: S of q equal to S of k, ``(D, Dv)`` in
    HEAD_DIM_PAIRS, one dtype (f32 or bf16) for q/k/v/out/dout,
    contiguous, and for bf16 (the tensor cores' 16-byte copies and
    ``ldmatrix``) 16-byte-aligned base addresses. Returns the code."""
    B, S, H, D = q.shape
    if k.shape[1] != S:
        raise ValueError(f"the kernels need Sq == Skv, got {S} and "
                         f"{k.shape[1]}")
    if (D, v.shape[-1]) not in HEAD_DIM_PAIRS:
        raise ValueError(f"head_dim pair (D, Dv) = {(D, v.shape[-1])} not "
                         f"in {HEAD_DIM_PAIRS}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"dtype {q.dtype} (float32 or bfloat16)")
    for t in (q, k, v) + tensors:
        if t.dtype != q.dtype:
            raise TypeError(f"mixed dtypes {q.dtype} and {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the kernels need contiguous tensors")
        if t.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError("the tensor cores need 16-byte-aligned bf16 "
                             "tensors")
    return _DTYPES[q.dtype]


def _pad_seq(t, n):
    return F.pad(t, (0, 0) * (t.dim() - 2) + (0, n)) if n else t


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def flash_attention_fwd_ref(q, k, v, causal=True, window=0, q_block=512,
                            kv_block=1024, *, q_offset=0, kv_valid_len=None,
                            cap=0.0):
    """Plain version of ``flash_attention_fwd``: ``_flash_fwd_impl``'s
    online softmax over (q_block × kv_block) tiles, with the tails padded
    and the padded keys masked. Returns ``out`` (q's dtype) and ``lse``.
    The keywords are the serving path's (``blocked_attention``), which
    the kernel does not take: ``q_offset`` the position of q[0], keys at
    or past ``kv_valid_len`` (default Skv) masked, scores soft-capped by
    ``cap``."""
    B, Sq, H, D = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    Dv, G = v.shape[-1], H // KVH
    scale = 1.0 / math.sqrt(D)
    qb, kb = min(q_block, Sq), min(kv_block, Skv)
    nq, nk = -(-Sq // qb), -(-Skv // kb)
    qf = _pad_seq(q, nq * qb - Sq).float()
    kf = _pad_seq(k, nk * kb - Skv).float()
    vp = _pad_seq(v, nk * kb - Skv)
    dev = q.device
    kv_pos = torch.arange(nk * kb, device=dev)
    kv_lim = Skv if kv_valid_len is None else kv_valid_len
    out = torch.empty((B, nq * qb, H, Dv), dtype=q.dtype, device=dev)
    lse = torch.empty((B, nq * qb, H), dtype=torch.float32, device=dev)
    for i in range(nq):
        rows = slice(i * qb, (i + 1) * qb)
        q_t = qf[:, rows].reshape(B, qb, KVH, G, D)
        q_pos = q_offset + torch.arange(i * qb, (i + 1) * qb, device=dev)
        m = torch.full((B, KVH, G, qb), NEG_INF, device=dev)
        l_run = torch.zeros((B, KVH, G, qb), device=dev)
        acc = torch.zeros((B, KVH, G, qb, Dv), device=dev)
        for j in range(nk):
            cols = slice(j * kb, (j + 1) * kb)
            s = torch.einsum("bqhgd,bkhd->bhgqk", q_t, kf[:, cols]) * scale
            if cap:
                s = torch.tanh(s / cap) * cap
            mask = (_tile_mask(q_pos, kv_pos[cols], causal, window)
                    & (kv_pos[cols] < kv_lim)[None, :])
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l_run = l_run * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p.to(v.dtype).float(),
                vp[:, cols].float())
            m = m_new
        o = (acc / torch.clamp_min(l_run, 1e-30)[..., None]).to(q.dtype)
        out[:, rows] = o.permute(0, 3, 1, 2, 4).reshape(B, qb, H, Dv)
        ls = m + torch.log(torch.clamp_min(l_run, 1e-30))
        lse[:, rows] = ls.permute(0, 3, 1, 2).reshape(B, qb, H)
    return out[:, :Sq], lse[:, :Sq]


def flash_attention_fwd(q, k, v, causal=True, window=0, q_block=512,
                        kv_block=1024):
    """Attention forward -> ``(out, lse)``. ``q_block`` / ``kv_block`` set
    the plain version's tiles (the CPU path); the kernel tiles on its own."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_fwd_ref(q, k, v, causal, window, q_block,
                                       kv_block)
    dt = _check_cuda(q, k, v)
    B, S, H, D = q.shape
    Dv = v.shape[-1]
    out = q.new_empty((B, S, H, Dv))
    lse = torch.empty((B, S, H), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    with torch.cuda.device(q.device):
        rc = _lib().repro_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, S, H, k.shape[2], D, Dv, int(bool(causal)),
            int(window), 1.0 / math.sqrt(D), dt, _build.stream_of(q))
    _build.check_rc(rc, "flash_attention_fwd")
    _build.count_launch(flash_attention_fwd)
    return out, lse


flash_attention_fwd.launches = 0


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------

def flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=True, window=0,
                            q_block=512, kv_block=1024):
    """Plain version of ``flash_attention_bwd``: ``_flash_bwd_impl``.
    Recomputes ``p = exp(s − lse)`` per tile; dk and dv accumulate in f32
    over the q tiles. Returns ``dq, dk, dv`` in the inputs' dtypes."""
    B, Sq, H, D = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    Dv, G = v.shape[-1], H // KVH
    scale = 1.0 / math.sqrt(D)
    qb, kb = min(q_block, Sq), min(kv_block, Skv)
    nq, nk = -(-Sq // qb), -(-Skv // kb)
    pq, pk = nq * qb - Sq, nk * kb - Skv
    dev = q.device
    delta = torch.sum(dout.float() * out.float(), dim=-1)      # (B,Sq,H)
    qf = _pad_seq(q, pq).float()
    dof = _pad_seq(dout, pq)
    lsep = _pad_seq(lse, pq)
    deltap = _pad_seq(delta, pq)
    kf = _pad_seq(k, pk).float()
    vf = _pad_seq(v, pk).float()
    kv_pos = torch.arange(nk * kb, device=dev)
    dq = torch.zeros((B, nq * qb, KVH, G, D), device=dev)
    dk = torch.zeros((B, nk * kb, KVH, D), device=dev)
    dv = torch.zeros((B, nk * kb, KVH, Dv), device=dev)
    for i in range(nq):
        rows = slice(i * qb, (i + 1) * qb)
        q_i = qf[:, rows].reshape(B, qb, KVH, G, D)
        do_i = dof[:, rows].reshape(B, qb, KVH, G, Dv)
        lse_i = lsep[:, rows].reshape(B, qb, KVH, G).permute(0, 2, 3, 1)
        dl_i = deltap[:, rows].reshape(B, qb, KVH, G).permute(0, 2, 3, 1)
        q_pos = torch.arange(i * qb, (i + 1) * qb, device=dev)
        dq_i = torch.zeros((B, qb, KVH, G, D), device=dev)
        for j in range(nk):
            cols = slice(j * kb, (j + 1) * kb)
            k_j, v_j = kf[:, cols], vf[:, cols]
            s = torch.einsum("bqhgd,bkhd->bhgqk", q_i, k_j) * scale
            mask = (_tile_mask(q_pos, kv_pos[cols], causal, window)
                    & (kv_pos[cols] < Skv)[None, :])
            s = torch.where(mask, s, NEG_INF)
            p = torch.exp(s - lse_i[..., None])
            dv[:, cols] += torch.einsum(
                "bhgqk,bqhgv->bkhv", p.to(dout.dtype).float(), do_i.float())
            dp = torch.einsum("bqhgv,bkhv->bhgqk", do_i.float(), v_j)
            ds = p * (dp - dl_i[..., None]) * scale
            dq_i = dq_i + torch.einsum("bhgqk,bkhd->bqhgd",
                                       ds.to(k.dtype).float(), k_j)
            dk[:, cols] += torch.einsum("bhgqk,bqhgd->bkhd",
                                        ds.to(q.dtype).float(), q_i)
        dq[:, rows] = dq_i
    dq = dq.reshape(B, nq * qb, H, D)[:, :Sq].to(q.dtype)
    return dq, dk[:, :Skv].to(k.dtype), dv[:, :Skv].to(v.dtype)


def flash_attention_bwd(q, k, v, out, lse, dout, causal=True, window=0,
                        q_block=512, kv_block=1024):
    """Attention backward -> ``(dq, dk, dv)``. dk and dv sum the G query
    heads of each KV head in a fixed order, without atomics."""
    _check(q, k, v, out, lse, dout)
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, out, lse, dout, causal,
                                       window, q_block, kv_block)
    dt = _check_cuda(q, k, v, out, dout)
    B, S, H, D = q.shape
    Dv = v.shape[-1]
    if out.shape != (B, S, H, Dv) or dout.shape != out.shape:
        raise ValueError(f"out and dout must be {(B, S, H, Dv)}, got "
                         f"{tuple(out.shape)} and {tuple(dout.shape)}")
    if lse.shape != (B, S, H) or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous f32 {(B, S, H)}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk, dv
    delta = torch.empty((B, S, H), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = _lib().repro_flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, S, H, k.shape[2], D, Dv,
            int(bool(causal)), int(window), 1.0 / math.sqrt(D), dt,
            _build.stream_of(q))
    _build.check_rc(rc, "flash_attention_bwd")
    _build.count_launch(flash_attention_bwd)
    return dq, dk, dv


flash_attention_bwd.launches = 0

class FlashAttention(torch.autograd.Function):
    """``out = attention(q, k, v)`` whose forward and backward are the
    wrappers above (the kernels on the card, the plain versions on the
    CPU); the backward reads ``(q, k, v, out, lse)`` saved by the forward,
    as the reference's custom VJP does."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_block, kv_block):
        out, lse = flash_attention_fwd(q, k, v, causal, window, q_block,
                                       kv_block)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = (causal, window, q_block, kv_block)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         dout.contiguous(), *ctx.cfg)
        return dq, dk, dv, None, None, None, None

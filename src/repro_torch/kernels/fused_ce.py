"""Fused cross-entropy, forward and backward: CUDA kernels, their plain
versions, their launch counters and the autograd function that joins them
(the port of ``repro/kernels/fused_ce.py`` ``fused_cross_entropy``, and of
the loss head of ``lm_loss``, ``repro/models/transformer.py:302``).

    fused_ce_fwd(h, w, targets)            -> loss, lse, pred     (per token)
    fused_ce_bwd(h, w, targets, lse, g)    -> dh, dw

h is ``(T, d)`` and w ``(d, V)``, both bf16 or f32; targets ``(T,)`` int64.
``loss_t = logsumexp_v(h_t·w) − (h_t·w)[y_t]``; ``pred`` is the argmax
with the first index winning ties (``jnp.argmax``). ``g`` is the per-token
upstream gradient; the backward forms ``(softmax − onehot)·g`` tile by
tile and returns ``dh = dlogits·wᵀ`` and ``dw = hᵀ·dlogits`` in h's and
w's dtypes. Logits are f32 products of the inputs, as the reference's
``preferred_element_type=f32`` einsum computes them.

The forward never holds the (T, V) logits in device memory: it keeps an
online max, sum, target logit and argmax per token over vocab tiles, in
vocab splits that a second launch merges in order (``vocab_splits``). The
bf16 backward takes the vocab in chunks of ``vocab_chunk`` columns: per
chunk it recomputes the logits, writes ``dlogits`` as bf16 hi + lo into two
(T, Vc) buffers and forms ``dh`` (summed over the chunks in an f32 buffer)
and the chunk's rows of ``dw``; the wrapper allocates the buffers and they
are freed when the call returns. The f32 backward recomputes each logits
tile inside the kernel that consumes it. The kernels read w as its
transpose ``(V, d)``, which is how the tied embedding already lies in
memory (``w = embed.T``).

A target of −1 takes part in no target logit and no one-hot: its loss is
``lse`` and its ``dlogits`` the softmax alone (the kernels already mark
their padding rows so). ``vocab_parallel_cross_entropy`` runs the loss
head on a vocabulary split over a ``model`` group: each rank's kernels see
its columns, with −1 for the targets other ranks hold; the global ``lse``
is the logsumexp of the ranks' (``all_reduce`` max, then sum), the target
logit and the argmax come from the rank that holds them, and the backward
kernel takes the global ``lse``, so its ``dh`` is the rank's part of the
sum over the vocabulary (the caller sums it over ``model``) and its ``dw``
the rank's columns whole.

A wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernels of ``csrc/fused_ce.cu`` or raises. bf16
rows run on the tensor cores, which need d a multiple of 16 and h at a
32-byte-aligned address; anything else raises. One wrapper call counts
one launch, however many kernels it enqueues. A nonzero
``logit_softcap`` raises ``NotImplementedError``: no config sets it.
"""
from __future__ import annotations

import ctypes

import torch
import torch.distributed as dist

from repro_torch.core import costmodel
from repro_torch.kernels import _build
from repro_torch.utils import opcount_hook

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_c_ptr, _c_int = ctypes.c_void_p, ctypes.c_int
# shared memory of the f32 backward: a 16-row f32 accumulator of width d,
# plus 44,800 bytes of tiles (csrc/fused_ce.cu), within the 232,448 of an
# H100
MAX_D = (232_448 - 44_800) // (16 * 4)
# the forward's (token tile, vocab tile, blocks to aim for): f32 64 x 64,
# four blocks an H100 SM; bf16 128 x 256, one block an SM, sixteen waves
_FWD_PLAN = {torch.float32: (64, 64, 4 * 132),
             torch.bfloat16: (128, 256, 16 * 132)}
_CHUNK_BYTES = 1 << 29    # the bf16 backward's hi + lo dlogits buffers


def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_ce")
    if lib.repro_ce_fwd.argtypes is None:
        lib.repro_ce_fwd.argtypes = [_c_ptr] * 8 + [_c_int] * 5 + [_c_ptr]
        lib.repro_ce_fwd.restype = ctypes.c_int
        lib.repro_ce_bwd.argtypes = [_c_ptr] * 10 + [_c_int] * 5 + [_c_ptr]
        lib.repro_ce_bwd.restype = ctypes.c_int
    return lib


def _check(h, w, targets, softcap) -> None:
    if softcap:
        raise NotImplementedError(
            "logit_softcap != 0 is not supported by the fused cross-entropy "
            "(no config sets it); see ROADMAP.md")
    if h.dim() != 2 or w.dim() != 2 or h.shape[1] != w.shape[0]:
        raise ValueError(f"expected h (T, d) and w (d, V); got "
                         f"{tuple(h.shape)}, {tuple(w.shape)}")
    if targets.shape != (h.shape[0],):
        raise ValueError(f"targets {tuple(targets.shape)} for "
                         f"{h.shape[0]} tokens")
    if w.device != h.device or targets.device != h.device:
        raise ValueError("h, w and targets must be on one device")
    if h.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {h.device}")


def _cuda_args(h, w, targets):
    """What the kernels take -> (dtype code, w as a contiguous (V, d))."""
    if h.dtype not in _DTYPES or w.dtype != h.dtype:
        raise TypeError(f"h {h.dtype} and w {w.dtype}: one of float32 / "
                        f"bfloat16")
    if targets.dtype != torch.int64 or not targets.is_contiguous():
        raise TypeError("targets must be contiguous int64")
    if not h.is_contiguous():
        raise ValueError("h must be contiguous")
    d = h.shape[1]
    if d % 2 or (h.dtype == torch.float32 and d > MAX_D):
        raise ValueError(f"d = {d}: the kernels take an even d, at most "
                         f"{MAX_D} in f32")
    wt = w.t().contiguous()
    if h.dtype == torch.bfloat16 and (
            d % 16 or h.data_ptr() % 32 or wt.data_ptr() % 32):
        raise ValueError(f"bf16 rows on the tensor cores need d % 16 == 0 "
                         f"(d = {d}) and 32-byte-aligned h and w")
    return _DTYPES[h.dtype], wt


def vocab_splits(T: int, V: int, dtype) -> tuple:
    """The forward's vocab splits -> ``(columns a split, splits)``: whole
    vocab tiles each, enough of them that the token tiles times the splits
    fill the card, covering V exactly (the last split may be ragged)."""
    rows, tile, target = _FWD_PLAN[dtype]
    n_vt = -(-V // tile)
    n_split = max(1, min(n_vt, -(-target // -(-T // rows))))
    per = -(-n_vt // n_split) * tile
    return per, -(-V // per)


def vocab_chunk(T: int, V: int) -> int:
    """The bf16 backward's vocab chunk Vc: a power of two, at least one
    vocab tile and no more than V needs, whose dlogits buffers (bf16 hi and
    lo of (T, Vc)) fit in 512 MiB; 32768 at T 4096."""
    vc = _FWD_PLAN[torch.bfloat16][1]
    while vc < V and 2 * T * (2 * vc) * 2 <= _CHUNK_BYTES:
        vc *= 2
    return vc


def bwd_scratch_bytes(T: int, V: int, d: int) -> int:
    """Device bytes the bf16 backward allocates for one call: the two
    dlogits buffers and, with more than one chunk, the f32 dh sum."""
    vc = vocab_chunk(T, V)
    return 2 * T * vc * 2 + (T * d * 4 if V > vc else 0)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _logits(h, w):
    return h.float() @ w.float()


def fused_ce_fwd_ref(h, w, targets):
    """Plain version of ``fused_ce_fwd``: dense logits, ``logsumexp`` and
    the target gather (``kernels/ref.py`` ``fused_ce_ref``); a −1 target's
    logit is 0."""
    logits = _logits(h, w)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(1, targets.clamp_min(0)[:, None])[:, 0]
    tgt = torch.where(targets >= 0, tgt, 0.0)
    return lse - tgt, lse, logits.argmax(dim=-1)


def _fwd_work(h, w, *_, **__) -> tuple:
    return costmodel.ce_fwd_work(h.shape[0], h.shape[1], w.shape[1],
                                 h.element_size())


def _bwd_work(h, w, *_, **__) -> tuple:
    return costmodel.ce_bwd_work(h.shape[0], h.shape[1], w.shape[1],
                                 h.element_size())


def _fwd_outputs(h, *_, **__) -> tuple:
    T = h.shape[0]
    return (h.new_empty(T, dtype=torch.float32),
            h.new_empty(T, dtype=torch.float32),
            h.new_empty(T, dtype=torch.int64))


def _bwd_outputs(h, w, *_, **__) -> tuple:
    # dw as the kernel returns it: the transpose of a (V, d) buffer
    out = torch.empty_like(h), w.new_empty((w.shape[1], w.shape[0])).t()
    # the bf16 route's dlogits chunk buffers, held while the kernel runs
    if h.dtype == torch.bfloat16:
        T, d = h.shape
        h.new_empty(bwd_scratch_bytes(T, w.shape[1], d), dtype=torch.uint8)
    return out


@opcount_hook.kernel_region(_fwd_work, _fwd_outputs)
def fused_ce_fwd(h, w, targets, logit_softcap: float = 0.0):
    """Per-token cross-entropy -> ``(loss, lse, pred)``: f32, f32, int64."""
    _check(h, w, targets, logit_softcap)
    if h.device.type == "cpu":
        return fused_ce_fwd_ref(h, w, targets)
    dt, wt = _cuda_args(h, w, targets)
    T, d = h.shape
    V = wt.shape[0]
    dev = h.device
    loss = torch.empty(T, dtype=torch.float32, device=dev)
    lse = torch.empty(T, dtype=torch.float32, device=dev)
    pred = torch.empty(T, dtype=torch.int64, device=dev)
    if T == 0:
        return loss, lse, pred
    if V == 0:
        raise ValueError("empty vocabulary")
    # a second launch inside the C function merges the splits in order
    v_per_split, n_split = vocab_splits(T, V, h.dtype)
    part_f = torch.empty((n_split, T, 4), dtype=torch.float32, device=dev)
    part_i = torch.empty((n_split, T), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _lib().repro_ce_fwd(
            h.data_ptr(), wt.data_ptr(), targets.data_ptr(),
            part_f.data_ptr(), part_i.data_ptr(), loss.data_ptr(),
            lse.data_ptr(), pred.data_ptr(), T, V, d, v_per_split, dt,
            _build.stream_of(h))
    _build.check_rc(rc, "fused_ce_fwd")
    _build.count_launch(fused_ce_fwd)
    return loss, lse, pred


fused_ce_fwd.launches = 0


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------

def fused_ce_bwd_ref(h, w, targets, lse, g):
    """Plain version of ``fused_ce_bwd``: the analytic gradient of the dense
    loss, ``dlogits = (softmax − onehot)·g``."""
    p = torch.exp(_logits(h, w) - lse[:, None])
    rows = torch.arange(h.shape[0], device=h.device)
    held = targets >= 0
    p[rows[held], targets[held]] -= 1.0
    dl = p * g[:, None].float()
    return (dl @ w.float().t()).to(h.dtype), (h.float().t() @ dl).to(w.dtype)


@opcount_hook.kernel_region(_bwd_work, _bwd_outputs)
def fused_ce_bwd(h, w, targets, lse, g, logit_softcap: float = 0.0):
    """Gradients of ``Σ_t g_t·loss_t`` -> ``(dh, dw)``."""
    _check(h, w, targets, logit_softcap)
    if h.device.type == "cpu":
        return fused_ce_bwd_ref(h, w, targets, lse, g)
    dt, wt = _cuda_args(h, w, targets)
    T, d = h.shape
    for name, t in (("lse", lse), ("g", g)):
        if t.shape != (T,) or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.device != h.device:
            raise ValueError(f"{name} must be contiguous f32 ({T},) on "
                             f"{h.device}")
    V = wt.shape[0]
    dh = torch.empty_like(h)
    dwt = torch.empty_like(wt)
    if T and V:
        vc, scratch = 0, [None] * 3
        if h.dtype == torch.bfloat16:
            # dlogits hi and lo of one chunk, and dh's f32 sum over chunks
            vc = vocab_chunk(T, V)
            dl = torch.empty((2, T, vc), dtype=h.dtype, device=h.device)
            acc = torch.empty((T, d) if V > vc else (1,),
                              dtype=torch.float32, device=h.device)
            scratch = [dl[0].data_ptr(), dl[1].data_ptr(), acc.data_ptr()]
        with torch.cuda.device(h.device):
            rc = _lib().repro_ce_bwd(
                h.data_ptr(), wt.data_ptr(), targets.data_ptr(),
                lse.data_ptr(), g.data_ptr(), dh.data_ptr(), dwt.data_ptr(),
                *scratch, T, V, d, vc, dt, _build.stream_of(h))
        _build.check_rc(rc, "fused_ce_bwd")
        _build.count_launch(fused_ce_bwd)
    else:
        dh.zero_()
        dwt.zero_()
    return dh, dwt.t()


fused_ce_bwd.launches = 0

class FusedCrossEntropy(torch.autograd.Function):
    """Per-token ``(loss, pred)`` whose forward and backward are the
    wrappers above; ``pred`` is not differentiable."""

    @staticmethod
    def forward(ctx, h, w, targets):
        loss, lse, pred = fused_ce_fwd(h, w, targets)
        ctx.save_for_backward(h, w, targets, lse)
        ctx.mark_non_differentiable(pred)
        return loss, pred

    @staticmethod
    def backward(ctx, dloss, _dpred):
        h, w, targets, lse = ctx.saved_tensors
        dh, dw = fused_ce_bwd(h, w, targets, lse, dloss.float().contiguous())
        return dh, dw, None


class _VocabParallelCE(torch.autograd.Function):
    """``(loss, pred)`` over a vocabulary split over ``group``: ``w`` holds
    the columns ``[v0, v0 + w.shape[1])``; ``h`` and ``targets`` are the
    same on every rank of the group."""

    @staticmethod
    def forward(ctx, h, w, targets, v0, group):
        local = targets - v0
        local = torch.where((local >= 0) & (local < w.shape[1]), local, -1)
        loss, lse, pred = fused_ce_fwd(h, w, local)
        # the best logit of this rank's columns, for the global argmax
        best = (h.float() * w[:, pred].t().float()).sum(-1)
        m = torch.stack([lse, best])
        opcount_hook.collective("all-reduce", m, group)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        # lse − loss is the target logit where this rank holds it, else 0
        s = torch.stack([torch.exp(lse - m[0]), lse - loss])
        opcount_hook.collective("all-reduce", s, group)
        dist.all_reduce(s, group=group)
        lse_g = m[0] + torch.log(s[0])
        # the first global index of the largest logit: max of V − index
        V = w.shape[1] * dist.get_world_size(group)
        cand = torch.where(best == m[1], V - (pred + v0), 0)
        opcount_hook.collective("all-reduce", cand, group)
        dist.all_reduce(cand, op=dist.ReduceOp.MAX, group=group)
        ctx.save_for_backward(h, w, local, lse_g)
        ctx.mark_non_differentiable(cand)
        return lse_g - s[1], V - cand

    @staticmethod
    def backward(ctx, dloss, _dpred):
        h, w, local, lse_g = ctx.saved_tensors
        dh, dw = fused_ce_bwd(h, w, local, lse_g.contiguous(),
                              dloss.float().contiguous())
        return dh, dw, None, None, None


def vocab_parallel_cross_entropy(h, w, targets, v0: int, group):
    """Per-token ``(loss, pred)`` of ``h`` against the vocabulary whose
    columns ``[v0, v0 + w.shape[1])`` this rank's ``w`` holds, the rest on
    the other ranks of ``group``; ``targets`` and ``pred`` are global
    indices. The gradient of ``h`` is this rank's part: sum it over
    ``group`` (``models.tp.copy_in``)."""
    return _VocabParallelCE.apply(h, w, targets, v0, group)

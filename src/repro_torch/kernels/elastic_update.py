"""The fused EASGD updates: CUDA kernels, their plain versions, and their
launch counters (the port of ``repro/kernels/elastic_update.py``).

    fused_sync_easgd_update   W' = W − η(G + ρ(W − C))
                              C' = C + ηρP(R/P − C)     (into center_out)
    fused_sync_sgd_update     V' = μV − η(R/P);  C' = C + V'
    fused_elastic_update      V' = μV − ηG
                              W' = W + V' − ηρ(W − C)
                              C' = C + ηρP(M − C)

The first two are the PS runtime's f64 bucket updates; R is the exchanged
sum of the P workers' rows. Both update their tensors IN PLACE, as the
reference's numpy path mutates its buffers; the center output of the
easgd update goes to ``center_out`` (the version-flipped center buffer),
or nowhere when it is None.

``fused_elastic_update`` is the multi-pod step's packed update (the
reference's Pallas ``fused_elastic_update``): W, V and G are ``(P, n)``
pod rows (or 1-D rows, P = 1), C and M ``(n,)``, each stored as f32 or
bf16, the math in f32; M is the pod mean of the pre-update W. It updates
W, V and C in place, where the reference returns new arrays.

A wrapper takes the plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel of ``csrc/elastic_update.cu`` on the current
stream or raises: there is no fallback. Each launch adds one to the
wrapper's ``launches`` attribute, a plain integer.

The plain versions are eager torch in the reference's operation order.
Every op rounds once, and the division by P goes through a tensor divisor
(PyTorch's CUDA ``div`` by a Python scalar multiplies by the reciprocal,
which is not the same bits), so the plain versions equal numpy on the CPU
and the kernels on the card bit for bit. The f32 update's constants are
formed in double as the reference's Python floats are (``(η·ρ)·P``) and
rounded to f32 once, by torch for the plain version and by ``ctypes`` for
the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import costmodel
from repro_torch.kernels import _build
from repro_torch.utils import opcount_hook

_c_ptr, _c_long, _c_double, _c_int = (ctypes.c_void_p, ctypes.c_long,
                                      ctypes.c_double, ctypes.c_int)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}    # the f32 update's codes


def _lib() -> ctypes.CDLL:
    lib = _build.load("elastic_update")
    if lib.repro_sync_easgd_update.argtypes is None:
        lib.repro_sync_easgd_update.argtypes = [
            _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_long,
            _c_double, _c_double, _c_double, _c_int, _c_ptr]
        lib.repro_sync_easgd_update.restype = ctypes.c_int
        lib.repro_sync_sgd_update.argtypes = [
            _c_ptr, _c_ptr, _c_ptr, _c_long, _c_double, _c_double, _c_int,
            _c_ptr]
        lib.repro_sync_sgd_update.restype = ctypes.c_int
        lib.repro_elastic_update.argtypes = (
            [_c_ptr] * 5 + [_c_long, _c_int] + [ctypes.c_float] * 4
            + [_c_int] * 5 + [_c_ptr])
        lib.repro_elastic_update.restype = ctypes.c_int
    return lib


def _check(*tensors: torch.Tensor) -> int:
    """All 1-D f64 contiguous tensors of one length on one device; returns
    the length."""
    t0 = tensors[0]
    for t in tensors:
        if t.dtype != torch.float64:
            raise TypeError(f"expected float64, got {t.dtype}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError("expected contiguous 1-D rows")
        if t.device != t0.device:
            raise ValueError(f"rows on {t0.device} and {t.device}")
        if t.numel() != t0.numel():
            raise ValueError(f"row lengths {t0.numel()} != {t.numel()}")
    if t0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t0.device}")
    return t0.numel()


def _divisor(p: int, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(float(p), dtype=torch.float64, device=like.device)


# ---------------------------------------------------------------------------
# Sync EASGD
# ---------------------------------------------------------------------------

def fused_sync_easgd_update_ref(w, grad, center, row, p: int, eta: float,
                                rho: float, center_out=None) -> None:
    """Plain version of ``fused_sync_easgd_update``: ``worker_step``'s
    elastic rule, then eq 2 on the exchanged sum, in place."""
    w.sub_(eta * (grad + rho * (w - center)))
    if center_out is not None:
        mean = row / _divisor(p, row)
        center_out.copy_(center + ((eta * rho) * p) * (mean - center))


def _sync_easgd_work(w, grad, center, row, p, eta, rho,
                     center_out=None) -> tuple:
    return (costmodel.sync_easgd_solo_work if center_out is None
            else costmodel.sync_easgd_work)(w.numel())


@opcount_hook.kernel_region(_sync_easgd_work)
def fused_sync_easgd_update(w, grad, center, row, p: int, eta: float,
                            rho: float, center_out=None) -> None:
    """One fused Sync EASGD update over a row (or a bucket of it), in place:
    ``w`` ← W' for this worker; ``center_out`` ← C' when given (rank 0
    writes the flipped center buffer; the other ranks pass None and read
    neither ``row`` nor write a center). The bits of W' are the same either
    way."""
    rows = (w, grad, center, row) + (() if center_out is None
                                      else (center_out,))
    n = _check(*rows)
    if w.device.type == "cpu":
        fused_sync_easgd_update_ref(w, grad, center, row, p, eta, rho,
                                    center_out)
        return
    if n == 0:
        return
    lib = _lib()
    with torch.cuda.device(w.device):
        rc = lib.repro_sync_easgd_update(
            w.data_ptr(), grad.data_ptr(), center.data_ptr(), row.data_ptr(),
            None if center_out is None else center_out.data_ptr(), n,
            float(eta), float(rho), (float(eta) * float(rho)) * p, int(p),
            torch.cuda.current_stream(w.device).cuda_stream)
    _build.check_rc(rc, "fused_sync_easgd_update")
    _build.count_launch(fused_sync_easgd_update)


fused_sync_easgd_update.launches = 0


# ---------------------------------------------------------------------------
# Sync SGD
# ---------------------------------------------------------------------------

def fused_sync_sgd_update_ref(center, vel, row, p: int, eta: float,
                              mu: float) -> None:
    """Plain version of ``fused_sync_sgd_update``: ``sync_master_sgd`` on
    the mean gradient row / P, in place."""
    vel.copy_(mu * vel - eta * (row / _divisor(p, row)))
    center.add_(vel)


@opcount_hook.kernel_region(
    lambda center, *_, **__: costmodel.sync_sgd_work(center.numel()))
def fused_sync_sgd_update(center, vel, row, p: int, eta: float,
                          mu: float) -> None:
    """One fused synchronous momentum-SGD master update, in place on
    ``center`` and ``vel``: V̄ ← μV̄ − η(R/P);  W̄ ← W̄ + V̄."""
    n = _check(center, vel, row)
    if center.device.type == "cpu":
        fused_sync_sgd_update_ref(center, vel, row, p, eta, mu)
        return
    if n == 0:
        return
    lib = _lib()
    with torch.cuda.device(center.device):
        rc = lib.repro_sync_sgd_update(
            center.data_ptr(), vel.data_ptr(), row.data_ptr(), n,
            float(eta), float(mu), int(p),
            torch.cuda.current_stream(center.device).cuda_stream)
    _build.check_rc(rc, "fused_sync_sgd_update")
    _build.count_launch(fused_sync_sgd_update)


fused_sync_sgd_update.launches = 0


# ---------------------------------------------------------------------------
# the multi-pod step's packed update
# ---------------------------------------------------------------------------

def _check_elastic(w, v, g, c, mean_w) -> tuple:
    """W, V, G ``(P, n)`` or ``(n,)``; C, M ``(n,)``; all f32 or bf16,
    contiguous, on one device. Returns ``(P, n)``."""
    for t in (w, v, g, c, mean_w):
        if t.dtype not in _DTYPES:
            raise TypeError(f"expected float32 or bfloat16, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("expected contiguous rows")
        if t.device != w.device:
            raise ValueError(f"rows on {w.device} and {t.device}")
    if w.dim() not in (1, 2) or v.shape != w.shape or g.shape != w.shape:
        raise ValueError(f"W, V, G must share one (P, n) or (n,) shape, got "
                         f"{tuple(w.shape)}, {tuple(v.shape)}, "
                         f"{tuple(g.shape)}")
    n = w.shape[-1]
    if c.shape != (n,) or mean_w.shape != (n,):
        raise ValueError(f"C and M must be ({n},), got {tuple(c.shape)} and "
                         f"{tuple(mean_w.shape)}")
    if w.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {w.device}")
    return (w.shape[0] if w.dim() == 2 else 1), n


def fused_elastic_update_ref(w, v, g, c, mean_w, *, eta: float, rho: float,
                             mu: float, n_workers: int) -> None:
    """Plain version of ``fused_elastic_update``: the reference's
    ``fused_elastic_step_flat`` on f32 copies, rounded back to each
    buffer's dtype, in place."""
    w32, v32, g32, c32, m32 = (t.float() for t in (w, v, g, c, mean_w))
    v_new = mu * v32 - eta * g32
    w_new = w32 + v_new - (eta * rho) * (w32 - c32)
    c_new = c32 + ((eta * rho) * n_workers) * (m32 - c32)
    w.copy_(w_new)
    v.copy_(v_new)
    c.copy_(c_new)


def _elastic_work(w, v, g, c, mean_w, **_) -> tuple:
    p = w.shape[0] if w.dim() == 2 else 1
    return costmodel.elastic_update_work(
        p, w.shape[-1], [t.element_size() for t in (w, v, g, c, mean_w)])


@opcount_hook.kernel_region(_elastic_work)
def fused_elastic_update(w, v, g, c, mean_w, *, eta: float, rho: float,
                         mu: float, n_workers: int) -> None:
    """One fused momentum-EASGD update over the packed pod rows, in place
    on ``w``, ``v`` and ``c`` (eqs 5–6 + 2); ``mean_w`` is the pod mean of
    the pre-update weights."""
    p, n = _check_elastic(w, v, g, c, mean_w)
    if w.device.type == "cpu":
        fused_elastic_update_ref(w, v, g, c, mean_w, eta=eta, rho=rho, mu=mu,
                                 n_workers=n_workers)
        return
    if n == 0:
        return
    er = float(eta) * float(rho)
    lib = _lib()
    with torch.cuda.device(w.device):
        rc = lib.repro_elastic_update(
            w.data_ptr(), v.data_ptr(), g.data_ptr(), c.data_ptr(),
            mean_w.data_ptr(), n, p, float(mu), float(eta), er,
            er * n_workers, *(_DTYPES[t.dtype] for t in (w, v, g, c, mean_w)),
            torch.cuda.current_stream(w.device).cuda_stream)
    _build.check_rc(rc, "fused_elastic_update")
    _build.count_launch(fused_elastic_update)


fused_elastic_update.launches = 0

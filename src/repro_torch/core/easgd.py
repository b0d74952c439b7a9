"""Elastic Averaging SGD family — paper §3.3, §5.1 (eqs. 1, 2, 5, 6); the
port of ``repro/core/easgd.py``.

The rules (paper notation; η learning rate, ρ elastic strength, μ momentum):

  worker  (eq 1):  W⁽ⁱ⁾ ← W⁽ⁱ⁾ − η·(ΔW⁽ⁱ⁾ + ρ·(W⁽ⁱ⁾ − W̄))
  center  (eq 2):  W̄    ← W̄ + η·ρ·Σᵢ (W⁽ⁱ⁾ − W̄)
  MEASGD  (eq 5):  V⁽ⁱ⁾ ← μ·V⁽ⁱ⁾ − η·ΔW⁽ⁱ⁾
  MEASGD  (eq 6):  W⁽ⁱ⁾ ← W⁽ⁱ⁾ + V⁽ⁱ⁾ − η·ρ·(W⁽ⁱ⁾ − W̄)

The functions are pure and take pytrees (nested dicts and tuples) of
tensors, in the reference's operation order. The multi-pod step does not
call them: its state is packed, and its update is the fused kernel of
``kernels.elastic_update``, whose oracle is ``fused_elastic_step_flat``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class EASGDConfig:
    """η learning rate, ρ elastic strength, μ momentum, τ communication
    period (workers exchange every ``tau`` local steps)."""

    eta: float = 0.01
    rho: float = 0.01
    mu: float = 0.9
    tau: int = 1
    nesterov: bool = False

    @property
    def alpha(self) -> float:
        """Elastic step size α = η·ρ (the EASGD paper's notation)."""
        return self.eta * self.rho


def _map(fn, *trees):
    """``fn`` over the matching leaves of several pytrees."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    if isinstance(trees[0], (tuple, list)):
        return tuple(_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


# ---------------------------------------------------------------------------
# worker-side updates
# ---------------------------------------------------------------------------

def sgd_update(w, grad, cfg: EASGDConfig):
    """Plain SGD: W ← W − η·ΔW (the ρ=0 degenerate case of eq 1)."""
    return _map(lambda w_, g_: w_ - cfg.eta * g_.to(w_.dtype), w, grad)


def msgd_update(w, v, grad, cfg: EASGDConfig):
    """Momentum SGD (eqs 3–4): V ← μV − ηΔW;  W ← W + V."""
    v_new = _map(lambda v_, g_: cfg.mu * v_ - cfg.eta * g_.to(v_.dtype),
                 v, grad)
    if cfg.nesterov:
        w_new = _map(lambda w_, v_, g_: w_ + cfg.mu * v_
                     - cfg.eta * g_.to(w_.dtype), w, v_new, grad)
    else:
        w_new = _map(lambda w_, v_: w_ + v_.to(w_.dtype), w, v_new)
    return w_new, v_new


def easgd_worker_update(w, grad, center, cfg: EASGDConfig):
    """Eq 1: W ← W − η(ΔW + ρ(W − W̄))."""
    return _map(lambda w_, g_, c_: w_ - cfg.eta * (
        g_.to(w_.dtype) + cfg.rho * (w_ - c_.to(w_.dtype))),
        w, grad, center)


def measgd_worker_update(w, v, grad, center, cfg: EASGDConfig):
    """Eqs 5–6: V ← μV − ηΔW;  W ← W + V − ηρ(W − W̄)."""
    v_new = _map(lambda v_, g_: cfg.mu * v_ - cfg.eta * g_.to(v_.dtype),
                 v, grad)
    w_new = _map(lambda w_, v_, c_: w_ + v_.to(w_.dtype)
                 - cfg.eta * cfg.rho * (w_ - c_.to(w_.dtype)),
                 w, v_new, center)
    return w_new, v_new


# ---------------------------------------------------------------------------
# center-side updates
# ---------------------------------------------------------------------------

def center_update_from_sum(center, sum_w, n_workers: int, cfg: EASGDConfig):
    """Eq 2 given Σᵢ W⁽ⁱ⁾:  W̄ ← W̄ + ηρ (Σᵢ W⁽ⁱ⁾ − P·W̄)."""
    a = cfg.alpha
    return _map(lambda c_, s_: c_ + a * (s_.to(c_.dtype) - n_workers * c_),
                center, sum_w)


def center_update_from_mean(center, mean_w, n_workers: int,
                            cfg: EASGDConfig):
    """Eq 2 given meanᵢ W⁽ⁱ⁾:  W̄ ← W̄ + ηρP·(mean − W̄)."""
    a = cfg.alpha * n_workers
    return _map(lambda c_, m_: c_ + a * (m_.to(c_.dtype) - c_),
                center, mean_w)


def center_update_single(center, w_i, cfg: EASGDConfig):
    """Round-robin / async form, one worker at a time (paper Alg. 1 line
    14):  W̄ ← W̄ + ηρ (W⁽ⁱ⁾ − W̄)."""
    a = cfg.alpha
    return _map(lambda c_, w_: c_ + a * (w_.to(c_.dtype) - c_), center, w_i)


# ---------------------------------------------------------------------------
# fused packed-buffer form (what the kernel implements)
# ---------------------------------------------------------------------------

def fused_elastic_step_flat(w_flat, v_flat, g_flat, c_flat, mean_w_flat,
                            n_workers: int, cfg: EASGDConfig):
    """One fused pass over the packed buffers: eqs 5–6 + eq 2.

        V  ← μV − ηG
        W  ← W + V − ηρ(W − C)
        C  ← C + ηρP(mean_W − C)      # mean over workers of PRE-update W

    All buffers are 1-D and of one dtype. Returns new tensors."""
    v_new = cfg.mu * v_flat - cfg.eta * g_flat
    w_new = w_flat + v_new - cfg.eta * cfg.rho * (w_flat - c_flat)
    c_new = c_flat + cfg.alpha * n_workers * (mean_w_flat - c_flat)
    return w_new, v_new, c_new


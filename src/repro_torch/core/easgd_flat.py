"""Flat-row, in-place optimizer updates on f64 torch tensors — the port of
``repro/core/easgd_flat.py``.

Every function mutates its tensors in place, as the reference mutates its
numpy buffers: the thread transport hands the SAME tensors to every worker,
so an in-place update is the publication.

Bitwise contract: each expression keeps the reference's operation order
and uses only binary ops that round once (no ``alpha=``, ``addcmul`` or
``lerp``, which fuse a multiply into an add), so on the CPU the results
equal numpy's bit for bit (pinned by tests/test_torch_elastic_update.py).
"""
from __future__ import annotations

import torch

from repro_torch.core.easgd import EASGDConfig

EASGD_WORKER_RULE = ("original_easgd", "async_easgd", "hogwild_easgd",
                     "sync_easgd")
SYNC_FAMILY = ("sync_sgd", "sync_easgd")
ASYNC_FAMILY = ("async_sgd", "async_easgd", "async_msgd", "async_measgd")
HOGWILD_FAMILY = ("hogwild_sgd", "hogwild_easgd")


def uses_velocity(algorithm: str) -> bool:
    """Does the worker-side rule carry a velocity buffer V⁽ⁱ⁾?"""
    return algorithm in ("async_msgd", "async_measgd")


def worker_step(algorithm: str, w: torch.Tensor, v: torch.Tensor,
                grad: torch.Tensor, center: torch.Tensor,
                cfg: EASGDConfig) -> None:
    """Worker-side update, in place on (w, v).

    EASGD rule (eq 1):   W ← W − η(ΔW + ρ(W − W̄))
    MEASGD (eqs 5–6):    V ← μV − ηΔW;  W ← W + V − ηρ(W − W̄)
    MSGD (eqs 3–4):      V ← μV − ηΔW;  W ← W + V
    SGD:                 W ← W − ηΔW
    """
    eta, rho, mu = cfg.eta, cfg.rho, cfg.mu
    if algorithm in EASGD_WORKER_RULE:
        w.sub_(eta * (grad + rho * (w - center)))
    elif algorithm == "async_measgd":
        v.copy_(mu * v - eta * grad)
        w.add_(v - cfg.alpha * (w - center))
    elif algorithm == "async_msgd":
        v.copy_(mu * v - eta * grad)
        w.add_(v)
    else:
        w.sub_(eta * grad)


def local_step(algorithm: str, w: torch.Tensor, v: torch.Tensor,
               grad: torch.Tensor, cfg: EASGDConfig) -> None:
    """Between-exchange update for τ>1, in place on (w, v): the worker's
    own rule without any center interaction."""
    if uses_velocity(algorithm):
        v.copy_(cfg.mu * v - cfg.eta * grad)
        w.add_(v)
    else:
        w.sub_(cfg.eta * grad)


def master_absorb(algorithm: str, center: torch.Tensor,
                  master_vel: torch.Tensor, w_i: torch.Tensor,
                  v_i: torch.Tensor, grad: torch.Tensor,
                  cfg: EASGDConfig) -> None:
    """Process ONE worker arrival at the master (async / Hogwild families),
    in place on (center, master_vel, w_i, v_i).

    SGD:    W̄ ← W̄ − ηΔW;                     worker re-reads W̄
    MSGD:   V̄ ← μV̄ − ηΔW;  W̄ ← W̄ + V̄;      worker re-reads W̄
    elastic: worker rule (eq 1 / 5–6), then W̄ ← W̄ + ηρ(W⁽ⁱ⁾ − W̄)

    Under the FCFS lock this whole block is atomic; lock-free (Hogwild) the
    calls of different workers interleave between their ops.
    """
    if algorithm in ("async_sgd", "hogwild_sgd"):
        center.sub_(cfg.eta * grad)
        w_i.copy_(center)
    elif algorithm == "async_msgd":
        master_vel.copy_(cfg.mu * master_vel - cfg.eta * grad)
        center.add_(master_vel)
        w_i.copy_(center)
    else:  # async_easgd / async_measgd / hogwild_easgd
        worker_step(algorithm, w_i, v_i, grad, center, cfg)
        center.add_(cfg.alpha * (w_i - center))


def master_absorb_round_robin(center: torch.Tensor, w_j: torch.Tensor,
                              v_j: torch.Tensor, grad: torch.Tensor,
                              cfg: EASGDConfig) -> None:
    """Original EASGD's serialized turn: worker rule + single-worker center
    pull, executed while worker j holds its round-robin turn."""
    worker_step("original_easgd", w_j, v_j, grad, center, cfg)
    center.add_(cfg.alpha * (w_j - center))


def sync_master_easgd(center: torch.Tensor, mean_w: torch.Tensor, p: int,
                      cfg: EASGDConfig) -> None:
    """Eq 2 given the cross-worker mean of the PRE-update weights:
    W̄ ← W̄ + ηρP(mean − W̄). ``cfg.alpha * p`` is one host scalar, as in
    the reference."""
    center.add_(cfg.alpha * p * (mean_w - center))


def sync_master_sgd(center: torch.Tensor, master_vel: torch.Tensor,
                    gmean: torch.Tensor, cfg: EASGDConfig) -> None:
    """Synchronous momentum SGD on the mean gradient:
    V̄ ← μV̄ − η·ḡ;  W̄ ← W̄ + V̄."""
    master_vel.copy_(cfg.mu * master_vel - cfg.eta * gmean)
    center.add_(master_vel)

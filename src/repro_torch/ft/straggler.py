"""Straggler mitigation policies (the port of ``repro/ft/straggler.py``).

The paper's asynchronous variants tolerate stragglers by construction: a
slow worker simply contributes later. For the deterministic Sync EASGD path
the policy is BOUNDED STALENESS: a pod that misses the exchange deadline is
left out of this round's elastic mean (its weights rejoin next round), the
center update becoming

    W̄ ← W̄ + ηρ Σ_{i ∈ alive} (W⁽ⁱ⁾ − W̄).

The mask math is numpy, as in the reference: ``obs.live`` feeds it real
telemetry (per-worker heartbeat rates) from the tcp master.
``masked_center_mean`` is the exchange-side helper, on tensors.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class StragglerPolicy:
    """Base: everyone always participates."""
    n_pods: int

    def participation(self, step: int, delays_s) -> np.ndarray:
        return np.ones((self.n_pods,), np.float32)


@dataclasses.dataclass
class BoundedStaleness(StragglerPolicy):
    """Exclude pods slower than ``deadline_factor`` × the median round
    time."""
    deadline_factor: float = 1.5
    min_quorum: float = 0.5

    def participation(self, step: int, delays_s) -> np.ndarray:
        delays = np.asarray(delays_s, np.float64)
        deadline = np.median(delays) * self.deadline_factor
        mask = (delays <= deadline).astype(np.float32)
        if mask.mean() < self.min_quorum:   # keep quorum: admit fastest half
            order = np.argsort(delays)
            mask = np.zeros_like(mask)
            mask[order[: max(1, int(np.ceil(self.n_pods * self.min_quorum)))]] = 1
        return mask


def masked_center_mean(w_pods: torch.Tensor, center_flat: torch.Tensor,
                       mask) -> torch.Tensor:
    """Mean over the participating pods only. ``w_pods``: (P, N);
    ``mask``: (P,) 0/1. Returns the center moved by the masked mean of
    W − center, in f32 as the reference computes it."""
    m = torch.as_tensor(np.asarray(mask), dtype=torch.float32,
                        device=w_pods.device)[:, None]
    denom = torch.clamp(m.sum(), min=1.0)
    return center_flat + (m * (w_pods - center_flat[None])).sum(0) / denom

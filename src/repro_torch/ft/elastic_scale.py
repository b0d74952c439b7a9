"""Elastic pod scaling — EASGD-native fault tolerance (the port of
``repro/ft/elastic_scale.py``).

EASGD's center weight W̄ is the durable state: a worker's contribution
enters through the elastic mean, so pods can leave (failure, preemption) or
join (capacity) between exchange rounds without a global barrier:

 * pod_leave: drop the pod's local (W, V) rows; the center is untouched —
   at most τ local steps of that pod's progress are lost.
 * pod_join:  the new pod seeds its local weights from the center (what
   Alg. 4 lines 4-7 do at init) with zero momentum.

Two families: the packed-state forms (``pod_join`` / ``pod_leave`` /
``rescale_pods`` on ``core.elastic.ElasticState``, whose ``(P, n)`` rows
are the reference's pod-stacked leaves) and the flat-row forms
(``pod_join_rows`` / ``pod_leave_rows`` on the PS runtime's ``(P, n)`` f64
tensors).
"""
from __future__ import annotations

import dataclasses

import torch


def _drop_row(x: torch.Tensor, pod_index: int) -> torch.Tensor:
    return torch.cat([x[:pod_index], x[pod_index + 1:]], dim=0)


def pod_leave(state, pod_index: int):
    """Remove one pod's local replica (n_pods -> n_pods − 1)."""
    new = dataclasses.replace(
        state, params=_drop_row(state.params, pod_index),
        momentum=_drop_row(state.momentum, pod_index))
    if state.ef_error is not None:
        new = dataclasses.replace(
            new, ef_error=_drop_row(state.ef_error, pod_index))
    return new


def pod_join(state):
    """Add one pod seeded from the center (n_pods -> n_pods + 1)."""
    row = state.center.to(state.params.dtype)[None]
    new = dataclasses.replace(
        state, params=torch.cat([state.params, row], dim=0),
        momentum=torch.cat([state.momentum,
                            torch.zeros_like(state.momentum[:1])], dim=0))
    if state.ef_error is not None:
        new = dataclasses.replace(new, ef_error=torch.cat(
            [state.ef_error, torch.zeros_like(state.ef_error[:1])], dim=0))
    return new


def rescale_pods(state, new_n_pods: int):
    """Resize to ``new_n_pods`` (a shrink drops the highest pods; a growth
    seeds from the center)."""
    cur = state.params.shape[0]
    while cur > new_n_pods:
        state = pod_leave(state, cur - 1)
        cur -= 1
    while cur < new_n_pods:
        state = pod_join(state)
        cur += 1
    return state


# --- flat-row forms: the PS runtime's state layout ---

def pod_leave_rows(workers_w: torch.Tensor, workers_v: torch.Tensor,
                   pod_index: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Drop row ``pod_index`` from the (P, n) local-replica tensors.

    The center is deliberately not an argument: EASGD's center never
    changes when a pod leaves — only the elastic mean's denominator does,
    and that is the reconfigured P′ the next exchange divides by.
    """
    if workers_w.ndim != 2 or not 0 <= pod_index < workers_w.shape[0]:
        raise ValueError(f"pod {pod_index} of rows {tuple(workers_w.shape)}")
    return (_drop_row(workers_w, pod_index).contiguous(),
            _drop_row(workers_v, pod_index).contiguous())


def pod_join_rows(workers_w: torch.Tensor, workers_v: torch.Tensor,
                  center: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Append one row seeded from the center with zero momentum
    ((P, n) -> (P + 1, n)) — Alg. 4's init, at run time."""
    if workers_w.ndim != 2 or center.shape != workers_w.shape[1:]:
        raise ValueError(f"center {tuple(center.shape)} for rows "
                         f"{tuple(workers_w.shape)}")
    row = center.to(workers_w.dtype)[None]
    return (torch.cat([workers_w, row], dim=0),
            torch.cat([workers_v, torch.zeros_like(row)], dim=0))

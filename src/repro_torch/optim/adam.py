"""Adam (the port of ``repro/optim/adam.py``): the moments in f32, ``step``
int32, the update in f32 and cast back to each parameter's dtype."""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models.common import tree_map
from repro_torch.optim.sgd import _lr_at, tree_map_n


class AdamState(NamedTuple):
    step: torch.Tensor
    m: object
    v: object


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0):
    def init(params):
        def z():
            return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device), params)
        return AdamState(torch.zeros((), dtype=torch.int32), z(), z())

    def update(grads, state, params):
        t = state.step + 1
        lr_t = _lr_at(lr, state.step)
        m = tree_map_n(lambda m_, g: b1 * m_ + (1 - b1) * g.to(torch.float32),
                       state.m, grads)
        v = tree_map_n(lambda v_, g: b2 * v_ + (1 - b2)
                       * torch.square(g.to(torch.float32)), state.v, grads)
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32),
                            t.to(torch.float32))
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32),
                            t.to(torch.float32))

        def upd(p, m_, v_):
            step_ = lr_t * (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
            if weight_decay:
                step_ = step_ + lr_t * weight_decay * p.to(torch.float32)
            return (p.to(torch.float32) - step_).to(p.dtype)

        return tree_map_n(upd, params, m, v), AdamState(t, m, v)

    return init, update

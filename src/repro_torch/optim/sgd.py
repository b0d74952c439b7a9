"""SGD and momentum SGD as ``(init, update)`` pairs over parameter trees of
tensors (the port of ``repro/optim/sgd.py``).

These are the inner optimizers of the EASGD family (the paper's worker
update); ``core.elastic`` runs the momentum form fused for the packed step.
``lr`` is a float or a schedule called with the state's int32 ``step``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models.common import (tree_leaves_with_path, tree_map,
                                       tree_unflatten)


def tree_map_n(fn, tree, *rest):
    """``fn`` over the leaves of trees of one structure, keeping it."""
    leaves = [[leaf for _, leaf in tree_leaves_with_path(t)]
              for t in (tree,) + rest]
    return tree_unflatten(tree, [fn(*xs) for xs in zip(*leaves)])


def _lr_at(lr, step):
    return lr(step) if callable(lr) else lr


class SGDState(NamedTuple):
    step: torch.Tensor


def sgd(lr):
    def init(params):
        return SGDState(torch.zeros((), dtype=torch.int32))

    def update(grads, state, params):
        lr_t = _lr_at(lr, state.step)
        new_params = tree_map_n(lambda p, g: p - lr_t * g.to(p.dtype),
                                params, grads)
        return new_params, SGDState(state.step + 1)

    return init, update


class MomentumState(NamedTuple):
    step: torch.Tensor
    velocity: object


def momentum_sgd(lr, mu: float = 0.9, nesterov: bool = False):
    """Paper eqs (3)-(4): V ← μV − ηΔW; W ← W + V."""
    def init(params):
        return MomentumState(torch.zeros((), dtype=torch.int32),
                             tree_map(torch.zeros_like, params))

    def update(grads, state, params):
        lr_t = _lr_at(lr, state.step)
        v = tree_map_n(lambda v_, g: mu * v_ - lr_t * g.to(v_.dtype),
                       state.velocity, grads)
        if nesterov:
            new_params = tree_map_n(
                lambda p, v_, g: p + mu * v_ - lr_t * g.to(p.dtype),
                params, v, grads)
        else:
            new_params = tree_map_n(lambda p, v_: p + v_.to(p.dtype),
                                    params, v)
        return new_params, MomentumState(state.step + 1, v)

    return init, update

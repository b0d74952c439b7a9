"""The port's optimizers and schedules (``repro_torch.optim``) against the
reference's ``repro.optim``: the same parameter tree and five steps of
gradients, drawn from a numpy seed, through both; f32 throughout, held to
1e-6 (absolute and relative)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as ref_optim
from repro_torch import optim

STEPS = 5
TOL = dict(rtol=1e-6, atol=1e-6)


def _tree(rng):
    return {"a": rng.standard_normal((4, 3)).astype(np.float32),
            "b": {"c": rng.standard_normal((5,)).astype(np.float32),
                  "d": rng.standard_normal((2, 2, 2)).astype(np.float32)}}


def _paths(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _paths(tree[k], path + (k,))]
    return [(path, tree)]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _close(got, want):
    got, want = dict(_paths(got)), dict(_paths(want))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   **TOL, err_msg=str(k))


SCHEDULES = {
    "constant": (lambda m: m.constant(0.1)),
    "warmup_cosine": (lambda m: m.linear_warmup_cosine(0.3, 3, 10, 0.01)),
    "warmup_cosine_no_floor": (lambda m: m.linear_warmup_cosine(1.0, 0, 4)),
    "step_decay": (lambda m: m.step_decay(0.5, 0.7, 2)),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_reference(name):
    ref, got = SCHEDULES[name](ref_optim), SCHEDULES[name](optim)
    for step in range(12):
        want = np.asarray(ref(jnp.asarray(step, jnp.int32)))
        out = got(torch.tensor(step, dtype=torch.int32))
        assert out.dtype == torch.float32 and out.shape == ()
        np.testing.assert_allclose(out.numpy(), want, **TOL)
        np.testing.assert_allclose(got(step).numpy(), want, **TOL)


OPTIMIZERS = {
    "sgd": lambda m, lr: m.sgd(lr),
    "momentum": lambda m, lr: m.momentum_sgd(lr, mu=0.9),
    "nesterov": lambda m, lr: m.momentum_sgd(lr, mu=0.8, nesterov=True),
    "adam": lambda m, lr: m.adam(lr),
    "adam_wd": lambda m, lr: m.adam(lr, b1=0.8, b2=0.99, eps=1e-6,
                                    weight_decay=0.01),
}


def _state_trees(state):
    return [s for s in state[1:]]


@pytest.mark.parametrize("lr_kind", ["float", "schedule"])
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_reference(name, lr_kind):
    rng = np.random.default_rng(3)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(STEPS)]
    if lr_kind == "float":
        ref_lr = got_lr = 0.05
    else:
        ref_lr = ref_optim.linear_warmup_cosine(0.05, 2, STEPS)
        got_lr = optim.linear_warmup_cosine(0.05, 2, STEPS)
    r_init, r_update = OPTIMIZERS[name](ref_optim, ref_lr)
    g_init, g_update = OPTIMIZERS[name](optim, got_lr)
    r_p = _map(jnp.asarray, params)
    g_p = _map(torch.from_numpy, params)
    r_s, g_s = r_init(r_p), g_init(g_p)
    assert type(g_s).__name__ == type(r_s).__name__
    assert g_s._fields == r_s._fields
    for g in grads:
        r_p, r_s = r_update(_map(jnp.asarray, g), r_s, r_p)
        g_p, g_s = g_update(_map(torch.from_numpy, g), g_s, g_p)
        _close(_map(lambda t: t.numpy(), g_p), r_p)
        assert int(g_s.step) == int(r_s.step)
        assert g_s.step.dtype == torch.int32
        for got_tree, want_tree in zip(_state_trees(g_s), _state_trees(r_s)):
            for (_, a), (_, b) in zip(_paths(got_tree), _paths(want_tree)):
                assert str(a.dtype).split(".")[-1] == str(b.dtype)
            _close(_map(lambda t: t.numpy(), got_tree), want_tree)

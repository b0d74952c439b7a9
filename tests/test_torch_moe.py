"""The MoE FFN of the port (``repro_torch.models.moe``) against the
reference's ``repro.models.moe.moe_block``, and grok-1-314b's reduced LM
against the reference's.

Inputs and parameters come from numpy seeds and go to both sides. The
reference's own routing is read from its run: its ``lax.top_k`` result
(top_p, top_e) and its one ``jnp.where`` (the condition is ``keep``, the
result ``slot``) are recorded by proxies of those two modules. Held:

* the routing equal as integers (top_e, keep, slot) at f32 compute, with
  the group count and capacity, on a case where capacity drops slots, a
  case whose T makes ``_effective_groups`` fall below ``dispatch_groups``,
  and a tied router (all weights 0, every probability 1/E), which pins
  ``lax.top_k``'s lower-index-first tie order;
* y and aux within 1e-5 (relative norm), the gradients of ``Σ y·g + aux``
  with respect to x and every parameter against ``jax.grad`` within 1e-4;
* y at bf16 compute within 1e-2;
* grok-1-314b's reduced ``lm_loss`` and gradient (tests/torch_lm_parity.py:
  f32 1e-5 / 1e-4 on the reference's init; bf16 1e-3 / 5e-2 with wq / wk
  at fan-in d_model, the config having no qk-norm).

Readings on this CPU: f32 y ≤ 1.8e-7, aux ≤ 9.3e-8, gradients ≤ 9.9e-7;
bf16 y 3.9e-3 (grok) and 5.6e-3 (deepseek); grok's LM f32 loss 0,
gradient 6.6e-5, bf16 (conditioned) loss 8.7e-5, gradient 7.9e-3.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import moe as ref_moe
from repro_torch import configs
from repro_torch.models import moe
from torch_lm_parity import assert_parity

ARCHS = ("grok-1-314b", "deepseek-v2-236b")
DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(arch, dt):
    j, t = DT[dt]
    return (dataclasses.replace(ref_configs.get(arch).reduced,
                                compute_dtype=j),
            dataclasses.replace(configs.get(arch).reduced, compute_dtype=t))


def _inputs(cfg, B, S, seed, router_scale=1.0, skew=0.0):
    """x (B, S, d) and the MoE params from ``seed``: each weight at std
    1/√fan-in; ``router_scale`` multiplies the router (0 ties it) and
    ``skew`` adds a shared direction to x that the router maps onto
    expert 0, so most tokens pick it and capacity drops slots."""
    rng = np.random.RandomState(seed)
    p = {}
    for name, d in sorted(moe.moe_defs(cfg).items()):
        p[name] = (rng.randn(*d.shape) / np.sqrt(d.shape[-2])).astype(
            np.float32)
    p["router"] *= router_scale
    x = rng.randn(B, S, cfg.d_model).astype(np.float32)
    if skew:
        u = rng.randn(cfg.d_model).astype(np.float32)
        x += skew * u
        p["router"][:, 0] += skew * u / np.dot(u, u)
    return x, p


class _Proxy:
    """A module whose ``name`` function records its arguments and result
    in ``seen`` and otherwise is the module."""

    def __init__(self, mod, name, seen):
        self._mod, self._name, self._seen = mod, name, seen

    def __getattr__(self, attr):
        fn = getattr(self._mod, attr)
        if attr != self._name:
            return fn

        def spy(*args, **kw):
            out = fn(*args, **kw)
            self._seen.append((args, out))
            return out
        return spy


def _reference(rcfg, x, p, monkeypatch):
    """The reference's (y, aux, routing) on numpy inputs, routing read
    from its own run: (top_p, top_e, keep, slot)."""
    tops, wheres = [], []
    monkeypatch.setattr(ref_moe, "lax", _Proxy(ref_moe.lax, "top_k", tops))
    monkeypatch.setattr(ref_moe, "jnp", _Proxy(ref_moe.jnp, "where", wheres))
    cd = rcfg.compute_dtype
    y, aux = ref_moe.moe_block(rcfg, {k: jnp.asarray(v) for k, v in
                                      p.items()}, jnp.asarray(x, cd))
    monkeypatch.undo()
    (_, (top_p, top_e)), = tops
    ((keep, _, _), slot), = wheres
    # the reference renormalises top_k's probabilities after the call
    top_p = np.asarray(top_p)
    top_p = top_p / np.maximum(top_p.sum(-1, keepdims=True), 1e-9)
    return y, aux, [np.asarray(a) for a in (top_p, top_e, keep, slot)]


def _port(pcfg, x, p):
    xt = torch.from_numpy(x).to(pcfg.compute_dtype)
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    r = moe.route(pcfg, pt["router"], xt)
    y, aux = moe.moe_block(pcfg, pt, xt)
    return y, aux, r


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# (arch, B, S, router scale, skew): random routing; skewed routing that
# drops slots; T = 6 tokens, so _effective_groups(6, 4) = 3; a tied router
ROUTING_CASES = [(a, 2, 16, 1.0, 0.0, "random") for a in ARCHS] + \
    [(a, 2, 16, 1.0, 3.0, "drops") for a in ARCHS] + \
    [(a, 1, 6, 1.0, 0.0, "groups") for a in ARCHS] + \
    [(a, 2, 8, 0.0, 0.0, "tied") for a in ARCHS]


@pytest.mark.parametrize("arch,B,S,scale,skew,what", ROUTING_CASES)
def test_routing_and_output_match_reference(arch, B, S, scale, skew, what,
                                            monkeypatch):
    rcfg, pcfg = _cfgs(arch, "f32")
    x, p = _inputs(pcfg, B, S, seed=B * S, router_scale=scale, skew=skew)
    y_ref, aux_ref, (top_p, top_e, keep, slot) = _reference(rcfg, x, p,
                                                            monkeypatch)
    y, aux, r = _port(pcfg, x, p)
    m = pcfg.moe
    assert r.G == ref_moe._effective_groups(B * S, m.dispatch_groups)
    np.testing.assert_array_equal(r.top_e.numpy(), top_e)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    np.testing.assert_array_equal(r.slot.numpy(), slot)
    assert _rel(r.top_p.numpy(), top_p) <= 1e-5
    if what == "drops":
        assert not keep.all() and keep.any()
    if what == "groups":
        assert r.G == 3 < m.dispatch_groups and r.Tg == 2
    if what == "tied":
        want = np.broadcast_to(np.arange(m.top_k), top_e.shape)
        np.testing.assert_array_equal(top_e, want)
    assert _rel(y.numpy(), y_ref) <= 1e-5
    assert abs(aux.item() - float(aux_ref)) <= 1e-5 * abs(float(aux_ref))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("skew", [0.0, 3.0])
def test_gradients_match_jax_grad(arch, skew):
    rcfg, pcfg = _cfgs(arch, "f32")
    B, S = 2, 16
    x, p = _inputs(pcfg, B, S, seed=5, skew=skew)
    g = np.random.RandomState(9).randn(B, S, pcfg.d_model).astype(np.float32)

    def ref_obj(params, xx):
        y, aux = ref_moe.moe_block(rcfg, params, xx)
        return jnp.sum(y * g) + aux
    want_p, want_x = jax.grad(ref_obj, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))

    pt = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = moe.moe_block(pcfg, pt, xt)
    ((y * torch.from_numpy(g)).sum() + aux).backward()
    assert _rel(xt.grad.numpy(), want_x) <= 1e-4
    for name in sorted(p):
        assert _rel(pt[name].grad.numpy(), want_p[name]) <= 1e-4, name


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_output_matches_reference(arch, monkeypatch):
    rcfg, pcfg = _cfgs(arch, "bf16")
    x, p = _inputs(pcfg, 2, 16, seed=3)
    y_ref, aux_ref, (_, top_e, keep, _) = _reference(rcfg, x, p,
                                                     monkeypatch)
    y, aux, r = _port(pcfg, x, p)
    assert y.dtype == torch.bfloat16
    assert _rel(y.float().numpy(), np.asarray(y_ref, np.float32)) <= 1e-2
    assert abs(aux.item() - float(aux_ref)) <= 1e-2 * abs(float(aux_ref))


def test_moe_block_gives_the_same_bits_twice():
    """Dispatch and combine gather, so two runs (and their gradients)
    agree bit for bit."""
    _, pcfg = _cfgs("deepseek-v2-236b", "f32")
    x, p = _inputs(pcfg, 2, 16, seed=4, skew=3.0)
    runs = []
    for _ in range(2):
        pt = {k: torch.from_numpy(v).requires_grad_(True)
              for k, v in p.items()}
        y, aux = moe.moe_block(pcfg, pt, torch.from_numpy(x))
        (y.square().sum() + aux).backward()
        runs.append([y.detach()] + [pt[k].grad for k in sorted(pt)])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dt,conditioned", [("f32", False), ("bf16", True)])
def test_grok_lm_loss_and_gradient_match_reference(dt, conditioned):
    assert_parity("grok-1-314b", dt, conditioned=conditioned)

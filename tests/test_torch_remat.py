"""Per-slot remat in the port's LM (``repro_torch.models.transformer``):
with ``cfg.remat`` other than "none" each period slot's layer runs under
``torch.utils.checkpoint`` when autograd records, as the reference
checkpoints each slot of its period scan; "dots" is "full"; the remainder
layers and a forward under ``no_grad`` are not checkpointed. On the CPU
the recompute gives the forward's values again, so loss and gradient are
those of remat "none" bit for bit; for the MoE families (grok-1-314b,
deepseek-v2-236b with MLA) the aux loss each slot returns through the
checkpoint too.
"""
import dataclasses

import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_chunk as sc
from repro_torch.models import transformer as tfm
from repro_torch.models.common import init_params

ARCHS = ("gemma3-27b", "recurrentgemma-2b", "mamba2-780m", "grok-1-314b",
         "deepseek-v2-236b")


def _setup(arch, S=20, B=2):
    cfg = configs.get(arch).reduced
    row = tfm.flatten_params(init_params(tfm.model_defs(cfg),
                                         torch.Generator().manual_seed(0)))
    gen = torch.Generator().manual_seed(1)
    tok = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen)
    batch = {"tokens": tok[:, :-1], "targets": tok[:, 1:],
             "mask": (torch.rand(B, S, generator=gen) > 0.2).float()}
    return cfg, row, batch


def _gradient(cfg, row, batch):
    leaf = row.to(torch.float32).requires_grad_(True)
    loss, metrics = tfm.lm_loss(cfg, tfm.unflatten(leaf, cfg), batch)
    loss.backward()
    return loss.detach(), leaf.grad, metrics


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_same_bits(arch):
    cfg, row, batch = _setup(arch)
    runs = {r: _gradient(dataclasses.replace(cfg, remat=r), row, batch)
            for r in ("none", "full", "dots", "some-other-policy")}
    loss0, grad0, m0 = runs["none"]
    assert torch.isfinite(grad0).all() and grad0.abs().max() > 0
    for r, (loss, grad, m) in runs.items():
        assert torch.equal(loss, loss0), r
        assert torch.equal(grad, grad0), r
        assert torch.equal(m["accuracy"], m0["accuracy"]), r
        assert torch.equal(m["aux"], m0["aux"]), r
    assert (m0["aux"] > 0) == (configs.get(arch).reduced.moe is not None)


@pytest.fixture
def count_checkpoints(monkeypatch):
    calls = []
    real = tfm.checkpoint

    def counted(fn, *args, **kw):
        calls.append(kw)
        return real(fn, *args, **kw)
    monkeypatch.setattr(tfm, "checkpoint", counted)
    return calls


@pytest.mark.parametrize("arch", ARCHS)
def test_each_period_slot_is_checkpointed_and_nothing_else(
        arch, count_checkpoints):
    cfg, row, batch = _setup(arch)
    slots = cfg.n_periods * len(cfg.pattern)
    _gradient(cfg, row, batch)
    assert len(count_checkpoints) == slots > 0
    assert all(kw == {"use_reentrant": False} for kw in count_checkpoints)
    count_checkpoints.clear()
    with torch.no_grad():                    # eval: nothing to recompute
        tfm.lm_loss(cfg, tfm.unflatten(row.float(), cfg), batch)
    assert count_checkpoints == []
    _gradient(dataclasses.replace(cfg, remat="none"), row, batch)
    assert count_checkpoints == []


@pytest.mark.parametrize("remat", ["full", "none"])
def test_attention_forwards_per_gradient(remat, monkeypatch):
    """A checkpointed slot runs its attention forward twice per gradient
    (the forward, then the recompute in the backward), a remainder layer
    once: gemma3-27b reduced has 6 period slots and 2 remainder layers,
    recurrentgemma reduced 1 attention slot and only RG-LRU remainders."""
    seen = []
    real = fa.flash_attention_fwd

    def counted(*args, **kw):
        seen.append(1)
        return real(*args, **kw)
    monkeypatch.setattr(fa, "flash_attention_fwd", counted)
    for arch, on, off in (("gemma3-27b", 2 * 6 + 2, 8),
                          ("recurrentgemma-2b", 2, 1)):
        cfg, row, batch = _setup(arch)
        seen.clear()
        _gradient(dataclasses.replace(cfg, remat=remat), row, batch)
        assert len(seen) == (on if remat == "full" else off), arch


def test_ssd_forwards_per_gradient(monkeypatch):
    seen = []
    real = sc.ssd_intra_fwd

    def counted(*args, **kw):
        seen.append(1)
        return real(*args, **kw)
    monkeypatch.setattr(sc, "ssd_intra_fwd", counted)
    cfg, row, batch = _setup("mamba2-780m")
    _gradient(cfg, row, batch)
    assert len(seen) == 2 * cfg.n_layers == 2 * cfg.n_periods
    seen.clear()
    _gradient(dataclasses.replace(cfg, remat="none"), row, batch)
    assert len(seen) == cfg.n_layers

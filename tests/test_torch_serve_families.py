"""Prefill and decode of every reduced config in the port
(``repro_torch.models.transformer.prefill`` / ``decode_step``) against the
reference's ``repro.models.transformer.prefill`` / ``decode_step``, and the
port's own teacher-forcing identity.

Both packages run at f32 compute on the reference's ``init_params``,
carried across by ``params_from_jax`` (tests/torch_serve_parity.py's
``family_walk``). Two rows are prefilled, then decoded one position at a
time to position 19; the logits of every call are held as the
reference's own serving test holds them (``assert_allclose``, rtol = atol
= 1e-4) and every cache leaf after the prefill and after each decode step
by relative norm 1e-4 (only the order of f32 sums differs). The prompt of
7 ends just before the reduced local layers' window of 8, so the decode
crosses the ring buffer's wrap twice. qwen2-vl-72b passes distinct t / h
/ w M-RoPE positions and 8 patch embeddings (its prompt 10, longer than
the patches); grok-1-314b and deepseek-v2-236b run at capacity factor 8,
as the reference's test runs them (tests/test_torch_serve_variants.py
holds them at their own capacity, and the local archs after a prompt
longer than the window).

The identity: ``prefill(S − k)`` and k decode steps give ``forward(S)``'s
last logits to 1e-4 (the reference's ``tests/test_models.py``, on the
port alone), for all ten configs, across the wrap.

Readings on this CPU: logits ≤ 4.4e-5 (max |err|),
cache leaves ≤ 4.1e-6 (relative norm); the identity ≤ 1.7e-5 (max
|err|).
"""
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.models import transformer as tfm
from repro_torch.models.common import init_params
from torch_serve_parity import (FAMILY_B, FAMILY_MAX_LEN, family_cfgs,
                                family_walk)

ARCH_IDS = sorted(configs.ARCHS)
MOE = ("deepseek-v2-236b", "grok-1-314b")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_and_decode_match_reference(arch):
    family_walk(arch, 10 if arch == "qwen2-vl-72b" else 7, arch in MOE)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_matches_teacher_forcing(arch):
    """prefill + step-by-step decode == the full forward (f32, MoE at
    capacity factor 8: no drops), across the ring buffer's wrap."""
    _, cfg = family_cfgs(arch, arch in MOE)
    B, S = FAMILY_B, FAMILY_MAX_LEN
    params = init_params(tfm.model_defs(cfg),
                         torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (B, S)))
    Sp = 7
    with torch.inference_mode():
        h, _, _ = tfm.forward(cfg, params, tokens)
        ref = tfm.logits_at(cfg, params, h[:, -1])
        caches = tfm.init_caches(cfg, B, S, device="cpu")
        lg, caches = tfm.prefill(cfg, params, tokens[:, :Sp], caches)
        for t in range(Sp, S):
            lg, caches = tfm.decode_step(cfg, params, tokens[:, t:t + 1],
                                         caches, torch.full((B,), t))
    np.testing.assert_allclose(lg.numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-4)

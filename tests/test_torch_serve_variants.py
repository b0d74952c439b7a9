"""Prefill and decode of the reduced configs' other serving cases in the
port against the reference (tests/torch_serve_parity.py's
``family_walk``; tests/test_torch_serve_families.py has the ten configs'
first case): the archs with local layers after a prompt of 12, longer
than their window of 8 (the ring buffer's roll), and grok-1-314b and
deepseek-v2-236b at their own capacity factor, where the MoE FFN may drop
slots of the B·1 decode tokens. f32 compute; logits rtol = atol = 1e-4,
every cache leaf after each call 1e-4 by relative norm.

Readings on this CPU: logits ≤ 1.8e-5 (max |err|),
cache leaves ≤ 7.5e-6 (relative norm).
"""
import pytest

from torch_serve_parity import family_walk

CASES = [("gemma3-27b", 12, False), ("gemma3-4b", 12, False),
         ("recurrentgemma-2b", 12, False), ("deepseek-v2-236b", 7, False),
         ("grok-1-314b", 7, False)]


@pytest.mark.parametrize("arch,n_prefill,capacity8", CASES)
def test_prefill_and_decode_match_reference(arch, n_prefill, capacity8):
    family_walk(arch, n_prefill, capacity8)

"""Serving every layer kind on a ``(data 2, model 2)`` mesh (a gloo world
of 4 ranks on the CPU, ``serve_kinds_world``), against the reference's
un-meshed ``prefill`` / ``decode_step``.

Each case carries the reference's ``init_params(PRNGKey(0))`` across at
f32 compute, prefills a prompt of 12 into caches of 32 positions and then
decodes 6 tokens (positions 12 to 17); every call's logits, gathered whole
on every rank, are held to the reference's at serving's f32 contract
(``assert_allclose``, rtol = atol = 1e-4), and every rank's cache leaves
must have their spec's ``local_shape``:

* mamba2-780m, B 8: the SSM conv columns and heads over ``model``;
* recurrentgemma-2b, B 8: the RG-LRU width over ``model``; its local
  layer's one kv head does not split, so the ring buffer of 8 slots splits
  its time over ``model`` (blocks of 4) while ``model`` splits the q
  heads; the prompt of 12 wraps the ring, and so do the decode steps;
* deepseek-v2-236b at B 8 (rows and experts over ``data``, the latent
  rank over ``model``) and at B 1 (``ckv`` and ``kpe`` time over
  ``data``);
* grok-1-314b, B 8 (experts over ``data``);
* gemma3-4b at B 1 and B 3, which ``data`` does not split: the global
  layer's cache splits its time over ``data`` in blocks of 16, so the
  decode steps cross the block boundary at 16, and rank 1's block holds
  no valid slot before it; the local layers' ring buffer splits too.

Two planted faults (``utils.faults``) in flash-decoding's combine, on
gemma3-4b at B 1, each read at least 100 times the limit: the combine
without the max rescale, and the last block's partial left out. A last
case holds the empty-block rule alone: the combine of two blocks at a
position below rank 1's equals attention over the whole cache, rank 1's
sum is 0 and its max the finite ``NEG_INF``.

Readings on this CPU (max |err| of the logits against the reference's):
grok-1-314b 1.2e-4 (logits near 5: within rtol), the others 4.2e-7 to
9.4e-6; the faults 1.41 (no rescale) and 1.35 (a block dropped).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as ref_configs
from repro.models import transformer as ref_tfm
from repro.models.common import init_params as ref_init
from test_torch_mesh_worlds import World, np_tree

L, PROMPT, DECODE = 32, 12, 6
TOL = 1e-4
ARCHS = ("mamba2-780m", "recurrentgemma-2b", "deepseek-v2-236b",
         "grok-1-314b", "gemma3-4b")
CASES = (
    {"name": "mamba2_b8", "arch": "mamba2-780m", "B": 8},
    {"name": "recurrentgemma_b8", "arch": "recurrentgemma-2b", "B": 8},
    {"name": "deepseek_b8", "arch": "deepseek-v2-236b", "B": 8},
    {"name": "deepseek_b1", "arch": "deepseek-v2-236b", "B": 1},
    {"name": "grok_b8", "arch": "grok-1-314b", "B": 8},
    {"name": "gemma3_b1", "arch": "gemma3-4b", "B": 1},
    {"name": "gemma3_b3", "arch": "gemma3-4b", "B": 3},
    {"name": "gemma3_b1_combine_no_rescale", "arch": "gemma3-4b", "B": 1,
     "fault": "combine_no_rescale"},
    {"name": "gemma3_b1_combine_drop", "arch": "gemma3-4b", "B": 1,
     "fault": "combine_drop"},
)
CLEAN = [c["name"] for c in CASES if "fault" not in c]
FAULTS = [c["name"] for c in CASES if "fault" in c]
# the caches whose time dim the specs split: (axes, block) on every rank
TIME = {"mamba2_b8": {}, "grok_b8": {}, "deepseek_b8": {},
        "recurrentgemma_b8": {"local": (("model",), 4)},
        "deepseek_b1": {"ckv": (("data",), 16), "kpe": (("data",), 16)},
        "gemma3_b1": {"attn": (("data",), 16), "local": (("data",), 4)},
        "gemma3_b3": {"attn": (("data",), 16), "local": (("data",), 4)}}


def _ref_cfg(arch):
    return dataclasses.replace(ref_configs.get(arch).reduced,
                               compute_dtype=jnp.float32)


def _tokens(case):
    rng = np.random.default_rng(len(case["name"]) + case["B"])
    vocab = ref_configs.get(case["arch"]).reduced.vocab_size
    return (rng.integers(0, vocab, (case["B"], PROMPT)),
            rng.integers(0, vocab, (case["B"], DECODE)))


def _reference(case, params):
    """The reference's logits of the prefill and of each decode step."""
    cfg = _ref_cfg(case["arch"])
    B = case["B"]
    prompt, decode = _tokens(case)
    caches = ref_tfm.init_caches(cfg, B, L)
    lg, caches = jax.jit(lambda p, t, c: ref_tfm.prefill(cfg, p, t, c))(
        params, jnp.asarray(prompt, jnp.int32), caches)
    out = [np.asarray(lg)]
    step = jax.jit(lambda p, t, c, q: ref_tfm.decode_step(cfg, p, t, c, q))
    for i in range(DECODE):
        pos = jnp.full((B,), PROMPT + i, jnp.int32)
        lg, caches = step(params, jnp.asarray(decode[:, i:i + 1], jnp.int32),
                          caches, pos)
        out.append(np.asarray(lg))
    return out


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    # jitted, the draws are the same and take half the time
    params = {a: jax.jit(lambda k, c=_ref_cfg(a): ref_init(
        ref_tfm.model_defs(c), k, c.param_dtype))(jax.random.PRNGKey(0))
        for a in ARCHS}
    cases = []
    for c in CASES:
        prompt, decode = _tokens(c)
        cases.append(dict(c, compute="float32", prompt=prompt,
                          decode=decode))
    world = World(4, "serve_kinds_world", {
        "L": L, "cases": cases,
        "params": {a: np_tree(p) for a, p in params.items()}},
        tmp_path_factory.mktemp("serve_kinds"))
    refs = {c["name"]: _reference(c, params[c["arch"]]) for c in CASES
            if "fault" not in c}
    refs.update({c["name"]: refs[c["name"].split("_combine")[0]]
                 for c in CASES if "fault" in c})
    yield {"world": world, "refs": refs}
    world.close()


@pytest.mark.parametrize("case", CLEAN)
def test_mesh_serving_matches_reference(served, case):
    outs = served["world"].results()
    got, want = outs[0][case], served["refs"][case]
    assert len(got["logits"]) == len(want) == DECODE + 1
    for call, (a, b) in enumerate(zip(got["logits"], want)):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL,
                                   err_msg=f"{case} call {call}")
    for r, o in enumerate(outs):
        # the logits whole on every rank, each cache leaf the rank's block
        for a, b in zip(o[case]["logits"], got["logits"]):
            np.testing.assert_array_equal(a, b)
        for have, spec in o[case]["shapes"]:
            assert have == spec, (case, r, have, spec)
        assert {k: (axes, blk) for k, (axes, _, blk)
                in o[case]["time"].items()} == TIME[case], (case, r)
    # the blocks of a split time dim: one a rank over its axes
    for name, (axes, _, _) in outs[0][case]["time"].items():
        idx = sorted({o[case]["time"][name][1] for o in outs})
        assert idx == list(range(2 ** len(axes))), (case, name, idx)


@pytest.mark.parametrize("case", FAULTS)
def test_combine_fault_exceeds_limit(served, case):
    got = served["world"].results()[0][case]["logits"]
    err = max(float(np.max(np.abs(a - b)))
              for a, b in zip(got, served["refs"][case]))
    assert err >= 100 * TOL, (case, err)


def test_empty_block_weighs_nothing(served):
    """At position 5 of 16 slots split over data in blocks of 8, rank 1's
    block has no valid slot: its partial (max ``NEG_INF``, sum 0) weighs
    nothing, and the combine equals attention over the whole cache."""
    for o in served["world"].results():
        e = o["empty_block"]
        assert e["err"] <= 1e-6, e
        if e["rank"] == 1:
            assert e["l"] == 0.0 and e["m"] == float(np.float32(-1e30)), e
        else:
            assert e["l"] > 0.0, e

"""The port's serving runtime (``repro_torch.runtime.serve``) against the
reference's ``repro.runtime.serve``, and the two examples that decode.

* ``build_serve_steps``: the prefill and decode callables, with the
  reference's argument order, against the reference's jitted steps on a
  one-device mesh, at f32 compute on the reference's ``init_params``: the
  logits of the prefill and of each decode step (rtol = atol = 1e-4, as
  the reference's serving test), every cache leaf (relative norm 1e-4);
  the abstract params and caches and the modality extras, shape for
  shape and dtype for dtype. gemma3-4b (decoding across its ring
  buffer's wrap), qwen2-vl-72b (M-RoPE positions and patch embeddings)
  and mamba2-780m.
* ``BatchingEngine``: the same requests through the reference's engine
  and the port's give the same tokens, at f32 compute on the reference's
  params: examples/serve.py's own workload (mamba2-780m reduced, 4 slots,
  6 requests) and gemma3-4b reduced (3 slots, 5 requests of 3 to 10
  tokens, 12 tokens each: requests join while others decode, and every
  slot's positions pass the window of 8). Every decode call's logits are
  held at rtol = atol = 1e-4, and before the tokens are compared the test
  requires, on every row whose argmax becomes a request's token (a
  prompt's last row; each active slot's row in a step), the reference's
  gap between its two largest logits to exceed twice that row's largest
  |port − reference| logit difference: no near tie decides a token by
  rounding. (An absolute floor of 1e-3 on the gap does not hold at these
  random-init vocabularies of 512: over the 60-72 argmaxes of each
  workload the smallest reference gaps read 8.6e-6 (mamba2), 4.1e-4
  (gemma3-4b) and 3.9e-4 (qwen1.5-4b), each run giving equal tokens.)
* ``caches_from_jax``: the port's decode continues from the reference's
  prefill caches (gemma3-4b, deepseek-v2-236b, mamba2-780m), logits and
  every cache leaf (read back by ``caches_to_numpy``) at 1e-4.
* ``examples/serve_torch.py`` and ``examples/quickstart_torch.py`` run on
  the CPU (``--device cpu``).
"""
import dataclasses
import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import transformer as ref_tfm
from repro.models.common import init_params as ref_init
from repro.runtime import serve as ref_serve
from repro.utils.jaxcompat import auto_mesh
from repro_torch import configs
from repro_torch.models import transformer as tfm
from repro_torch.models.common import tree_leaves_with_path
from repro_torch.runtime import serve
from torch_serve_parity import rel

REPO = Path(__file__).resolve().parents[1]


def _setup(arch):
    rcfg = dataclasses.replace(ref_configs.get(arch).reduced,
                               compute_dtype=jnp.float32)
    pcfg = dataclasses.replace(configs.get(arch).reduced,
                               compute_dtype=torch.float32)
    params = ref_init(ref_tfm.model_defs(rcfg), jax.random.PRNGKey(0),
                      jnp.float32)
    return rcfg, pcfg, params, tfm.params_from_jax(params, pcfg,
                                                   device="cpu")[0]


def _same_records(got, want):
    g = tree_leaves_with_path(got)
    w = jax.tree_util.tree_leaves_with_path(want)
    assert len(g) == len(w)
    for (_, a), (_, b) in zip(g, w):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype).split(".")[-1] == str(b.dtype), (a, b)


def _hold_caches(got, want):
    g = tree_leaves_with_path(tfm.caches_to_numpy(got))
    w = jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for (path, a), b in zip(g, w):
        assert rel(a, np.asarray(b, np.float32)) <= 1e-4, path


@pytest.mark.parametrize("arch,n_prefill", [("gemma3-4b", 7),
                                            ("qwen2-vl-72b", 10),
                                            ("mamba2-780m", 5)])
def test_build_serve_steps_match_reference(arch, n_prefill):
    B, max_len = 2, 16
    rcfg, pcfg, params, pp = _setup(arch)
    mesh = auto_mesh((1, 1), ("data", "model"))
    ref = ref_serve.build_serve_steps(rcfg, mesh, batch=B, max_len=max_len)
    got = serve.build_serve_steps(pcfg, batch=B, max_len=max_len,
                                  device="cpu")
    _same_records(got.abstract_params, ref.abstract_params)
    _same_records(got.abstract_caches, ref.abstract_caches)
    assert got.param_specs is None and got.token_spec is None
    for S in (1, n_prefill):
        _same_records(serve._extra_kwargs(pcfg, B, S),
                      ref_serve._extra_kwargs(rcfg, B, S))

    rng = np.random.RandomState(3)
    tok = rng.randint(0, rcfg.vocab_size, (B, max_len))
    extras = {}
    if pcfg.mrope_sections is not None:
        s = np.arange(max_len)
        mpos = np.broadcast_to(np.stack([s, s // 4, s % 4])[:, None],
                               (3, B, max_len)).astype(np.int32)
        extras = {"mrope_positions": mpos[..., :n_prefill].copy(),
                  "patch_embeds": rng.randn(B, pcfg.patch_embed_tokens,
                                            pcfg.d_model).astype(np.float32)}
    want, rc = ref.prefill(params, jnp.asarray(tok[:, :n_prefill]),
                           {k: jnp.asarray(v) for k, v in extras.items()})
    served = got.cast_params(pp)
    lg, pc = got.prefill(served, torch.from_numpy(tok[:, :n_prefill]),
                         {k: torch.from_numpy(v) for k, v in extras.items()})
    np.testing.assert_allclose(lg.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    _hold_caches(pc, rc)
    for t in range(n_prefill, max_len):
        ex = ({} if not extras else
              {"mrope_positions": mpos[..., t:t + 1].copy()})
        pos = np.full((B,), t, np.int32)
        want, rc = ref.decode(params, rc, jnp.asarray(tok[:, t:t + 1]),
                              jnp.asarray(pos),
                              {k: jnp.asarray(v) for k, v in ex.items()})
        lg, pc = got.decode(served, pc, torch.from_numpy(tok[:, t:t + 1]),
                            torch.from_numpy(pos.astype(np.int64)),
                            {k: torch.from_numpy(v) for k, v in ex.items()})
        np.testing.assert_allclose(lg.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)
    _hold_caches(pc, rc)


@pytest.mark.parametrize("arch", ["gemma3-4b", "deepseek-v2-236b",
                                  "mamba2-780m"])
def test_decode_from_the_reference_prefill_cache(arch):
    """``caches_from_jax`` carries the reference's prefill caches across:
    the port's decode steps from them give the reference's logits (rtol =
    atol = 1e-4) and, read back by ``caches_to_numpy``, its cache leaves
    (relative norm 1e-4), across the reduced local layers' wrap."""
    B, max_len, n_prefill = 2, 14, 6
    rcfg, pcfg, params, pp = _setup(arch)
    tok = np.random.RandomState(4).randint(0, rcfg.vocab_size, (B, max_len))
    _, rc = jax.jit(lambda p, t, c: ref_tfm.prefill(rcfg, p, t, c))(
        params, jnp.asarray(tok[:, :n_prefill]),
        ref_tfm.init_caches(rcfg, B, max_len))
    pc = tfm.caches_from_jax(rc, pcfg, device="cpu")
    _hold_caches(pc, rc)
    decode = jax.jit(lambda p, t, c, pos: ref_tfm.decode_step(rcfg, p, t, c,
                                                              pos))
    for t in range(n_prefill, max_len):
        pos = np.full((B,), t, np.int32)
        want, rc = decode(params, jnp.asarray(tok[:, t:t + 1]), rc,
                          jnp.asarray(pos))
        with torch.inference_mode():
            got, pc = tfm.decode_step(pcfg, pp,
                                      torch.from_numpy(tok[:, t:t + 1]), pc,
                                      torch.from_numpy(pos.astype(np.int64)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)
        _hold_caches(pc, rc)


def _serve_all(eng, prompts, gen):
    """examples/serve.py's loop: submit while slots are free, then step."""
    pending, done = list(prompts), 0
    while done < len(prompts):
        while pending:
            if eng.submit(pending[0]) is None:
                break
            pending.pop(0)
        done += len(eng.step(stop_len=gen))
    return eng.outputs


def _recorded(eng, decode):
    """Wrap ``eng``'s submit / step to record, in call order, the logits
    of each decode call (``decode(result) -> logits`` reads them from the
    engine's ``_decode`` result) and which (call, row) pairs become a
    request's token: a prompt's last call at its slot, each active slot's
    row in a step."""
    calls, used = [], []
    inner, submit, step = eng._decode, eng.submit, eng.step

    def recording_decode(*args):
        out = inner(*args)
        calls.append(np.asarray(decode(out), np.float64))
        return out

    def recording_submit(prompt):
        slot = eng.active.index(False) if False in eng.active else None
        rid = submit(prompt)
        if rid is not None:
            used.append((len(calls) - 1, slot))
        return rid

    def recording_step(stop_len=16):
        active = list(eng.active)
        done = step(stop_len)
        used.extend((len(calls) - 1, r) for r, a in enumerate(active) if a)
        return done
    eng._decode, eng.submit, eng.step = (recording_decode, recording_submit,
                                         recording_step)
    return calls, used


@pytest.mark.parametrize("arch,slots,max_len,lens,gen", [
    # examples/serve.py's own workload: its default arch, 4 slots, 6
    # requests of 3 to 7 tokens from RandomState(0), 12 tokens, max_len 64
    ("mamba2-780m", 4, 64, None, 12),
    # a local-window arch: every slot's positions pass the window of 8
    ("gemma3-4b", 3, 32, (3, 10, 5, 8, 4), 12)])
def test_batching_engine_matches_reference_token_for_token(arch, slots,
                                                           max_len, lens,
                                                           gen):
    rcfg, pcfg, params, pp = _setup(arch)
    rng = np.random.RandomState(0)
    if lens is None:
        prompts = [list(rng.randint(0, rcfg.vocab_size,
                                    size=rng.randint(3, 8)))
                   for _ in range(6)]
    else:
        prompts = [list(rng.randint(0, rcfg.vocab_size, size=n))
                   for n in lens]
    ref = ref_serve.BatchingEngine(rcfg, params, batch=slots,
                                   max_len=max_len)
    want_calls, used = _recorded(ref, lambda out: out[0])
    want = _serve_all(ref, prompts, gen)
    eng = serve.BatchingEngine(pcfg, pp, batch=slots, max_len=max_len,
                               device="cpu")
    got_calls, got_used = _recorded(eng, lambda out: out)
    got = _serve_all(eng, prompts, gen)

    assert len(got_calls) == len(want_calls) and got_used == used
    for g, w in zip(got_calls, want_calls):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    # no near tie decides a token: on every row whose argmax becomes a
    # token, the reference's top-2 gap exceeds twice the row's largest
    # |port − reference| logit difference
    for c, r in used:
        top2 = np.sort(want_calls[c][r])[-2:]
        diff = np.abs(got_calls[c][r] - want_calls[c][r]).max()
        assert top2[1] - top2[0] > 2 * diff, (c, r, top2, diff)
    assert got == want and len(got) == len(prompts)
    assert all(len(v) == gen for v in got.values())


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,argv,expect", [
    ("serve_torch", ["--arch", "gemma3-4b", "--requests", "3", "--gen", "4",
                     "--device", "cpu"], "served 3 requests, 12 tokens"),
    ("quickstart_torch", ["--steps", "2", "--device", "cpu"],
     "greedy decode from center weights:")])
def test_example_runs_on_the_cpu(name, argv, expect, capsys):
    src = (REPO / "examples" / f"{name}.py").read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|repro)(\.|\s)", src,
                         re.M)
    _example(name).main(argv)
    assert expect in capsys.readouterr().out

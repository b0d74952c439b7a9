"""The eight model families ported after gemma3-4b and mamba2-780m:
qwen1.5-4b, phi3-mini-3.8b, gemma3-27b, musicgen-medium,
recurrentgemma-2b, qwen2-vl-72b, and the MoE ones, grok-1-314b and
deepseek-v2-236b (with MLA). This file holds the three dense ones (QKV
bias, SwiGLU / GeGLU, MHA) against the reference, the registry, the
layouts and parameter counts of all eight, and the launcher on each;
gemma3-27b and qwen2-vl-72b are in tests/test_torch_families_wide.py,
recurrentgemma-2b in tests/test_torch_rglru.py, grok-1-314b in
tests/test_torch_moe.py and deepseek-v2-236b in tests/test_torch_mla.py.

``lm_loss`` and its flat gradient against ``repro.models.transformer.
lm_loss`` on the reference's own ``init_params``, at f32 and bf16 compute
(tests/torch_lm_parity.py: loss 1e-5 / 1e-3, gradient 1e-4 / 5e-2). These
three have no qk-norm, so the bf16 cases and musicgen's f32 case run on
that init with ``wq`` / ``wk`` at fan-in d_model ("conditioned"; at the
reference's own init its gradient is too ill-conditioned to compare,
tests/torch_lm_parity.py). Readings on this CPU:

* qwen1.5-4b: f32 loss 7.0e-8, gradient 8.1e-5; bf16 (conditioned) loss
  1.9e-4, gradient 8.5e-3;
* phi3-mini-3.8b: f32 1.4e-7, 3.7e-5; bf16 (conditioned) 9.6e-5, 8.1e-3;
* musicgen-medium (conditioned): f32 loss 0, gradient 4.3e-7; bf16
  1.3e-5, 8.0e-3.
"""
import dataclasses
import math

import jax
import pytest

from repro.models import transformer as ref_tfm
from repro import configs as ref_configs
from repro_torch import configs
from repro_torch.launch import train as launcher
from repro_torch.models import transformer as tfm
from repro_torch.ps import zoo
from torch_lm_parity import assert_parity, ref_layout

SIX = ("qwen1.5-4b", "phi3-mini-3.8b", "gemma3-27b", "musicgen-medium",
       "recurrentgemma-2b", "qwen2-vl-72b")
MOE = ("grok-1-314b", "deepseek-v2-236b")
EIGHT = SIX + MOE
# the FULL configs' parameter counts, from the reference's defs
N_FULL = {"qwen1.5-4b": 3_950_369_280, "phi3-mini-3.8b": 3_821_079_552,
          "gemma3-27b": 27_008_335_616, "musicgen-medium": 1_818_379_776,
          "recurrentgemma-2b": 2_894_574_080,
          "qwen2-vl-72b": 72_706_203_648,
          "grok-1-314b": 316_489_340_928,
          "deepseek-v2-236b": 239_375_569_920}
# the sub-configs, compared field for field
SUBCONFIGS = ("rglru", "moe", "mla", "ssm")


# (arch, compute, q / k at fan-in d_model)
DENSE_CASES = [("qwen1.5-4b", "f32", False), ("qwen1.5-4b", "bf16", True),
               ("phi3-mini-3.8b", "f32", False),
               ("phi3-mini-3.8b", "bf16", True),
               ("musicgen-medium", "f32", True),
               ("musicgen-medium", "bf16", True)]


@pytest.mark.parametrize("arch,dt,conditioned", DENSE_CASES)
def test_dense_lm_loss_and_gradient_match_reference(arch, dt, conditioned):
    assert_parity(arch, dt, conditioned=conditioned)


@pytest.mark.parametrize("arch", EIGHT)
def test_ravel_layout_is_the_reference_leaf_order(arch):
    assert [(p, tuple(s)) for p, s in
            tfm.ravel_layout(configs.get(arch).reduced)] == ref_layout(arch)


def _ref_count(cfg) -> int:
    defs = ref_tfm.model_defs(cfg)
    leaves = jax.tree_util.tree_leaves(
        defs, is_leaf=lambda x: hasattr(x, "logical"))
    return sum(math.prod(d.shape) for d in leaves)


@pytest.mark.parametrize("arch", EIGHT)
def test_full_config_counts_the_reference_params(arch):
    spec, ref = configs.get(arch), ref_configs.get(arch)
    assert tfm.n_params(spec.config) == _ref_count(ref.config) == \
        N_FULL[arch]
    # field for field, dtypes by name
    for name in ("config", "reduced"):
        mine, theirs = getattr(spec, name), getattr(ref, name)
        for field in mine.__dataclass_fields__:
            a, b = getattr(mine, field), getattr(theirs, field)
            if field.endswith("_dtype"):
                assert str(a).split(".")[-1] == str(b).split(".")[-1].split(
                    "'")[0], (name, field)
            elif field in SUBCONFIGS and a is not None:
                assert dataclasses.asdict(a) == dataclasses.asdict(b), field
            else:
                assert a == b, (name, field)
    assert spec.shapes == ref.shapes
    assert spec.train_microbatches == ref.train_microbatches
    for field in ("momentum_dtype", "center_dtype"):
        assert str(getattr(spec, field)).split(".")[-1] == getattr(
            ref, field).__name__


@pytest.mark.parametrize("arch", EIGHT)
def test_registry_zoo_and_launcher_take_the_id(arch, capsys):
    assert configs.get(arch).arch_id == arch
    lm = zoo.resolve(arch)
    assert lm.factory == "repro_torch.ps.zoo:make_zoo_lm"
    assert lm.kwargs == (("arch", arch),)
    losses = launcher.main(["--arch", arch, "--reduced", "--steps", "2",
                            "--batch", "2", "--seq", "16", "--log-every",
                            "1", "--device", "cpu"])
    assert len(losses) == 2 and all(map(math.isfinite, losses))
    assert "exchange:" in capsys.readouterr().out


@pytest.mark.parametrize("kind", ["moe", "moe_dense"])
def test_a_moe_layer_kind_raises_as_the_reference_does(kind):
    """There is no MoE layer kind: MoE is ``cfg.moe`` on every non-SSM
    layer. A ``moe*`` kind is an unknown kind, in both packages."""
    mine = dataclasses.replace(configs.get("grok-1-314b").reduced,
                               pattern=(kind,))
    theirs = dataclasses.replace(ref_configs.get("grok-1-314b").reduced,
                                 pattern=(kind,))
    with pytest.raises(ValueError, match="unknown layer kind"):
        tfm.model_defs(mine)
    with pytest.raises(ValueError, match="unknown layer kind"):
        ref_tfm.model_defs(theirs)

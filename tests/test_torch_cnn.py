"""The port's CNNs (``repro_torch.models.cnn``) and zoo problems
(``repro_torch.ps.zoo``) against the reference's, on the reference's own
weights carried across by ``params_from_jax``.

Tolerance: a relative norm ≤ 1e-5 on logits and on the f32 gradient row.
Both sides compute in f32 with convolutions and sums in different orders;
on the CPU the gap measures ~2e-6 for AlexNet and ~4e-7 for LeNet.
"""
import math

import jax
import numpy as np
import pytest
import torch
from jax import flatten_util

from repro.data.synthetic import make_classification_dataset as ref_dataset
from repro.models import cnn as ref_cnn
from repro.ps import zoo as ref_zoo
from repro_torch.data.synthetic import make_classification_dataset
from repro_torch.models import cnn
from repro_torch.ps import zoo

TOL = 1e-5
SHAPES = {"alexnet": (32, 32, 3), "lenet": (28, 28, 1)}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module", params=["alexnet", "lenet"])
def model(request):
    """(name, reference params, reference flat row, reference zoo problem
    built with the same init)."""
    name = request.param
    params = getattr(ref_cnn, f"{name}_init")(jax.random.PRNGKey(0))
    flat, _ = flatten_util.ravel_pytree(params)
    return name, params, np.asarray(flat), ref_zoo.make_zoo_cnn(name)


def test_dataset_is_bitwise_the_reference():
    for shape in ((32,), (28, 28, 1)):
        x, y = make_classification_dataset(64, shape=shape, seed=3,
                                           noise=1.6)
        rx, ry = ref_dataset(64, shape=shape, seed=3, noise=1.6)
        np.testing.assert_array_equal(x, rx)
        np.testing.assert_array_equal(y, ry)


def test_layout_and_parameter_count(model):
    name, params, flat, (w0, ref_grad, _) = model
    layout = cnn.ravel_layout(name)
    assert [k for k, _ in layout] == sorted(params)
    assert [s for _, s in layout] == [params[k].shape for k in sorted(params)]
    assert sum(math.prod(s) for _, s in layout) == flat.size
    if name == "alexnet":
        assert flat.size == 6_976_842
    _, grad_fn, _ = zoo.make_zoo_cnn(name, w0=w0, device="cpu")
    assert grad_fn.layer_sizes == ref_grad.layer_sizes


def test_params_from_jax_round_trips(model):
    name, params, flat, _ = model
    p_dict, row = cnn.params_from_jax(
        {k: np.asarray(v) for k, v in params.items()}, model=name,
        device="cpu")
    np.testing.assert_array_equal(row.numpy(), flat.astype(np.float64))
    for k, v in params.items():
        np.testing.assert_array_equal(p_dict[k].numpy(), np.asarray(v))
    p_row, row2 = cnn.params_from_jax(flat, model=name, device="cpu")
    assert torch.equal(row, row2)
    for k in params:
        assert torch.equal(p_row[k], p_dict[k])
    with pytest.raises(ValueError):
        cnn.params_from_jax(flat[:-1], model=name, device="cpu")


def test_logits_match_reference(model):
    name, params, flat, _ = model
    x, _ = ref_dataset(8, shape=SHAPES[name], n_classes=10, noise=1.6,
                       seed=5)
    want = np.asarray(getattr(ref_cnn, f"{name}_apply")(params, x))
    p_dict, _ = cnn.params_from_jax(flat, model=name, device="cpu")
    got = getattr(cnn, f"{name}_apply")(p_dict, torch.from_numpy(x))
    assert got.shape == want.shape
    assert _rel(got.detach().numpy(), want) <= TOL


def test_zoo_gradients_match_jax_grad(model):
    """The port's grad_fn and the reference's jitted ``jax.grad`` on the
    same weights draw the same minibatches (worker streams 1000+worker)
    and agree on the flat f32 gradient row."""
    name, _, _, (w0, ref_grad, ref_eval) = model
    row, grad_fn, eval_fn = zoo.make_zoo_cnn(name, w0=w0, device="cpu")
    np.testing.assert_array_equal(row.numpy(), w0)
    for step, worker in ((0, 0), (1, 0), (0, 1)):
        want = ref_grad(w0, step, worker)
        got = grad_fn(row, step, worker)
        assert got.dtype == torch.float64 and got.shape == (w0.size,)
        assert _rel(got.numpy(), want) <= TOL, (step, worker)
    # test error over 256 images: one flipped argmax moves it by 1/256
    assert abs(eval_fn(row) - ref_eval(w0)) <= 1 / 256


def test_own_init_is_seeded_and_he_scaled():
    w_a, _, _ = zoo.make_zoo_cnn("lenet", seed=3, device="cpu")
    w_b, _, _ = zoo.make_zoo_cnn("lenet", seed=3, device="cpu")
    w_c, _, _ = zoo.make_zoo_cnn("lenet", seed=4, device="cpu")
    assert torch.equal(w_a, w_b) and not torch.equal(w_a, w_c)
    params = cnn.unflatten(w_a, "lenet")
    assert float(params["c1b"].abs().max()) == 0.0
    std = float(params["f1w"].std())
    assert abs(std - math.sqrt(2.0 / 784)) < 0.1 * math.sqrt(2.0 / 784)


def test_zoo_resolve_names():
    assert zoo.resolve("alexnet").factory == "repro_torch.ps.zoo:make_zoo_cnn"
    assert zoo.resolve("tiny-mlp").kwargs == ref_zoo.resolve(
        "tiny-mlp").kwargs
    lm, ref_lm = zoo.resolve("gemma3-4b"), ref_zoo.resolve("gemma3-4b")
    assert lm.factory == "repro_torch.ps.zoo:make_zoo_lm"
    assert ref_lm.factory == "repro.ps.zoo:make_zoo_lm"
    assert lm.kwargs == ref_lm.kwargs == (("arch", "gemma3-4b"),)
    assert zoo.resolve("jax-mlp").factory == \
        "repro_torch.ps.problems:make_jax_mlp"
    assert ref_zoo.resolve("jax-mlp").factory == \
        "repro.ps.problems:make_jax_mlp"
    # every arch id resolves as the reference's does, the MoE ones too
    for arch in ("deepseek-v2-236b", "grok-1-314b"):
        assert zoo.resolve(arch).kwargs == ref_zoo.resolve(arch).kwargs
    with pytest.raises(ValueError):
        zoo.resolve("no-such-model")
    with pytest.raises(ValueError):
        zoo.make_zoo_cnn("resnet", device="cpu")


def test_cuda_default_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        zoo.make_zoo_cnn("lenet")

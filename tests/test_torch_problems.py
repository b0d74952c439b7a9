"""The ``jax-mlp`` problem in the port (``models.cnn.mlp_init`` /
``mlp_apply``, ``ps.problems.make_jax_mlp``, ``ps.zoo``), against the
reference (``repro.models.cnn``, ``repro.ps.problems.make_jax_mlp``,
``repro.ps.zoo``).

The reference computes in f32 under XLA, the port in f32 under torch
autograd, so their sums differ in order: logits, gradients and a short
PS run are held to a relative norm ‖port − reference‖ / ‖reference‖ of
1e-5 (the f32 forward limit of the CNN tests; the readings sit near
1e-7). Batch draws, layouts, layer sizes, the eval's error and the zoo's
names are held exactly.
"""
import jax
import numpy as np
import pytest
import torch
from jax import flatten_util

from repro import ps as ref_ps
from repro.core.easgd import EASGDConfig as RefConfig
from repro.models import cnn as ref_cnn
from repro.ps import problems as ref_problems
from repro.ps import zoo as ref_zoo
from repro_torch.core.easgd import EASGDConfig
from repro_torch.models import cnn
from repro_torch.ps import problems, runtime, zoo

LIMIT = 1e-5
DIMS = {"d_in": 32, "d_hidden": 64, "depth": 2}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture
def ref_mlp():
    """A fresh build of the reference's jax-mlp at its defaults: (w0,
    grad_fn, eval_fn), its workers' batch streams not yet drawn from."""
    return ref_problems.make_jax_mlp()


@pytest.mark.parametrize("d_in,d_hidden,n_classes,depth", [
    (32, 64, 4, 2), (16, 8, 10, 3), (64, 128, 10, 1)])
def test_mlp_apply_on_the_references_params(d_in, d_hidden, n_classes,
                                            depth):
    params = ref_cnn.mlp_init(jax.random.PRNGKey(5), d_in=d_in,
                              d_hidden=d_hidden, n_classes=n_classes,
                              depth=depth)
    mine, row = cnn.params_from_jax(
        {k: np.asarray(v) for k, v in params.items()}, "mlp", n_classes,
        device="cpu", d_in=d_in, d_hidden=d_hidden, depth=depth)
    flat, _ = flatten_util.ravel_pytree(params)
    np.testing.assert_array_equal(row.numpy(),
                                  np.asarray(flat, np.float64))
    # the flat row alone carries the same dict
    again, _ = cnn.params_from_jax(np.asarray(flat), "mlp", n_classes,
                                   device="cpu", d_in=d_in,
                                   d_hidden=d_hidden, depth=depth)
    for k in mine:
        assert torch.equal(mine[k], again[k]), k
    x = np.random.RandomState(1).randn(16, d_in).astype(np.float32)
    want = np.asarray(ref_cnn.mlp_apply(params, x, depth=depth))
    got = cnn.mlp_apply(mine, torch.from_numpy(x), depth=depth).numpy()
    assert _rel(got, want) <= LIMIT


def test_mlp_layout_is_ravel_pytrees():
    """Sorted keys (``b0, b1, b_out, w0, w1, w_out``): the row order and
    the layer sizes of the reference's ``ravel_pytree`` / tree_leaves."""
    layout = cnn.ravel_layout("mlp", 4, **DIMS)
    assert [k for k, _ in layout] == ["b0", "b1", "b_out", "w0", "w1",
                                      "w_out"]
    init = cnn.mlp_init(torch.Generator().manual_seed(0), n_classes=4,
                        device="cpu", **DIMS)
    assert {k: tuple(v.shape) for k, v in init.items()} == \
        dict(layout)
    assert float(init["b0"].abs().max()) == 0.0
    with pytest.raises(ValueError, match="lenet/alexnet/mlp"):
        cnn.param_shapes("resnet")


def test_grad_and_eval_match_the_reference(ref_mlp):
    """The first steps of two workers on the reference's w0: the same
    batch indices (``RandomState(1000 + worker)``), gradients within the
    f32 limit, the same eval error."""
    w0, ref_grad, ref_eval = ref_mlp
    row, grad_fn, eval_fn = problems.make_jax_mlp(w0=w0, device="cpu")
    np.testing.assert_array_equal(row.numpy(), w0)
    assert row.dtype == torch.float64
    w = torch.from_numpy(w0)
    worst = 0.0
    for worker in (0, 1):
        for step in range(3):
            g = grad_fn(w, step, worker)
            assert g.dtype == torch.float64 and g.shape == w.shape
            worst = max(worst, _rel(g.numpy(), ref_grad(w0, step, worker)))
    assert worst <= LIMIT, worst
    assert eval_fn(w) == ref_eval(w0)
    moved = w0 - 0.5 * ref_grad(w0, 9, 7)
    assert eval_fn(torch.from_numpy(moved)) == ref_eval(moved)


def test_layer_sizes_and_zoo_names_equal(ref_mlp):
    _, ref_grad, _ = ref_mlp
    _, grad_fn, _ = problems.make_jax_mlp(device="cpu")
    assert grad_fn.layer_sizes == ref_grad.layer_sizes
    assert zoo.zoo_names() == ref_zoo.zoo_names()
    spec = zoo.resolve("jax-mlp")
    assert spec == problems.JAX_MLP
    assert spec.factory.split(":")[1] == \
        ref_zoo.resolve("jax-mlp").factory.split(":")[1] == "make_jax_mlp"
    assert spec.kwargs == ref_zoo.resolve("jax-mlp").kwargs
    with pytest.raises(ValueError, match="unknown model"):
        zoo.resolve("resnet")


def test_port_init_is_seeded_and_he_normal():
    a, _, _ = problems.make_jax_mlp(seed=3, device="cpu")
    b, _, _ = problems.make_jax_mlp(seed=3, device="cpu")
    c, _, _ = problems.make_jax_mlp(seed=4, device="cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    w1 = cnn.unflatten(a, "mlp", 4, **DIMS)["w1"]
    assert abs(float(w1.std()) - (2.0 / 64) ** 0.5) < 0.1 * (2.0 / 64) ** 0.5
    with pytest.raises(ValueError, match="elements"):
        problems.make_jax_mlp(w0=np.zeros(7), device="cpu")


@pytest.mark.parametrize("algo", ["sync_easgd", "sync_sgd"])
def test_ps_run_matches_the_reference(ref_mlp, algo):
    """A short thread run from the reference's w0: the port's center and
    workers within the f32 limit of the reference's, the same counters."""
    w0, ref_grad, ref_eval = ref_mlp
    kw = dict(algorithm=algo, n_workers=2, total_iters=16, schedule="ring",
              eval_every_iters=10**9)
    ref = ref_ps.run_ps((w0, ref_grad, ref_eval),
                        RefConfig(eta=0.1, rho=0.1, mu=0.9),
                        ref_ps.PSConfig(**kw))
    port = runtime.run_ps(problems.make_jax_mlp(w0=w0, device="cpu"),
                          EASGDConfig(eta=0.1, rho=0.1, mu=0.9),
                          runtime.PSConfig(**kw), device="cpu")
    assert _rel(port.center.numpy() - w0, ref.center - w0) <= LIMIT
    assert _rel(port.workers.numpy() - w0, ref.workers - w0) <= LIMIT
    for key in ("sync_rounds", "messages", "wire_bytes"):
        assert port.counters[key] == ref.counters[key], key


def test_process_transport_rebuilds_it_spawn_safe():
    """Spawned workers rebuild the autograd problem from its spec; the run
    is bit for bit the thread run's (the same code in each process)."""
    kw = dict(algorithm="sync_easgd", n_workers=2, total_iters=8,
              schedule="ring", eval_every_iters=10**9)
    easgd = EASGDConfig(eta=0.1, rho=0.1, mu=0.9)
    proc = runtime.run_ps(zoo.resolve("jax-mlp"), easgd,
                          runtime.PSConfig(transport="process", **kw),
                          device="cpu")
    thread = runtime.run_ps(zoo.resolve("jax-mlp"), easgd,
                            runtime.PSConfig(**kw), device="cpu")
    assert proc.total_iters == 8
    assert torch.equal(proc.center, thread.center)
    assert torch.equal(proc.workers, thread.workers)

"""The port's multi-pod exchange stack against the reference: the packer
(``core.packing``), the fused update's plain version
(``kernels.elastic_update.fused_elastic_update_ref``), the compressions,
the schedules' all-reduce over pod rows, the exchange plan and
``core.elastic.apply_gradients``.

Tolerances (each beside its reason):

* the packer's layout and pack / unpack: exact;
* the plain update against the reference's ``elastic_update_ref``: the
  1e-6 (f32) and 2e-2 (bf16) of ``tests/test_kernels.py``; against the
  Pallas kernel in interpret mode under the reference's no-FMA pin
  (``--xla_cpu_max_isa=SSE4_2``): bit for bit;
* the schedules' all-reduce against ``shard_map`` on 8 host devices: rtol
  1e-6 (another order of f32 sums);
* the update rules and the exchange on the same inputs as the reference:
  rtol 1e-6, atol 1e-7 (in process the reference's XLA may contract a
  multiply and an add into one FMA; the port never does);
* compressed exchanges: the same, except sign_ef, whose decoded mean and
  error feedback scale every sign by the mean |value| the two frameworks
  sum in different orders: rtol 1e-5, atol 1e-6.
"""
import dataclasses
import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as ref_configs
from repro.comm import plan as ref_plan
from repro.core import compression as ref_comp
from repro.core import elastic as ref_elastic
from repro.core import packing as ref_packing
from repro.core.easgd import EASGDConfig as RefEASGD
from repro.models import transformer as ref_tfm
from repro.models.common import init_params as ref_init
from repro.utils.jaxcompat import auto_mesh
from repro_torch import configs, kernels
from repro_torch.comm import plan, schedules
from repro_torch.core import compression, elastic, packing
from repro_torch.core.easgd import EASGDConfig
from repro_torch.kernels import elastic_update as eu
from repro_torch.models import transformer as tfm
from repro_torch.models.common import tree_leaves_with_path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
ETA, RHO, MU = 0.1, 0.05, 0.9
TOL = dict(rtol=1e-6, atol=1e-7)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# the packer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gemma_params():
    """The reference's reduced gemma3-4b params and the same values as
    port tensors."""
    cfg = ref_configs.get("gemma3-4b").reduced
    params = ref_init(ref_tfm.model_defs(cfg), jax.random.PRNGKey(0),
                      jnp.float32)
    ported = tfm.unflatten(torch.from_numpy(np.concatenate(
        [np.asarray(x).reshape(-1) for x in jax.tree_util.tree_leaves(
            params)])), configs.get("gemma3-4b").reduced)
    return params, ported


@pytest.mark.parametrize("align", [1, 1024, packing.ELASTIC_UPDATE_BLOCK])
def test_packer_layout_matches_reference(gemma_params, align):
    params, ported = gemma_params
    ref = ref_packing.Packer(params, align=align)
    port = packing.Packer(ported, align=align)
    assert packing.ELASTIC_UPDATE_BLOCK == ref_packing.ELASTIC_UPDATE_BLOCK
    assert [(s.shape, s.offset, s.size) for s in port.specs] == \
        [(s.shape, s.offset, s.size) for s in ref.specs]
    assert (port.n_elements, port.buffer_size) == \
        (ref.n_elements, ref.buffer_size)
    assert port.layer_sizes() == ref.layer_sizes()
    for target in (1000, 8192, 65536, 10**6):
        assert port.bucket_bounds(target) == ref.bucket_bounds(target)


def test_pack_unpack_round_trip_and_reference_buffer(gemma_params):
    params, ported = gemma_params
    port = packing.Packer(ported)
    buf = port.pack(ported)
    np.testing.assert_array_equal(
        buf.numpy(), np.asarray(ref_packing.Packer(params).pack(params)))
    back = port.unpack(buf)
    for (pa, a), (pb, b) in zip(tree_leaves_with_path(ported),
                                tree_leaves_with_path(back)):
        assert pa == pb and a.dtype == b.dtype
        assert torch.equal(a, b)
    doubled = packing.packed_apply(port, lambda b: b * 2, ported)
    assert torch.equal(doubled["embed"], ported["embed"] * 2)


# ---------------------------------------------------------------------------
# the fused update's plain version
# ---------------------------------------------------------------------------

def _ref_module():
    """``repro/kernels/ref.py`` by file path (``repro.kernels`` does not
    import on current jax)."""
    spec = importlib.util.spec_from_file_location(
        "kernels_ref", os.path.join(SRC, "repro", "kernels", "ref.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the cases of tests/test_kernels.py's elastic-update test
KERNEL_CASES = [(1 << 12, "float32"), (1 << 14, "float32"),
                (1 << 12, "bfloat16")]


def _update_inputs(n, dtype, seed=2):
    rng = np.random.RandomState(seed + n)
    arrays = [rng.randn(n).astype(np.float32) for _ in range(5)]
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    # copies: JAX may alias the numpy buffers, and the port updates in place
    tx = [torch.tensor(a).to(getattr(torch, dtype)) for a in arrays]
    return jx, tx


@pytest.mark.parametrize("n,dtype", KERNEL_CASES)
def test_plain_update_matches_reference_oracle(n, dtype):
    jx, tx = _update_inputs(n, dtype)
    want = _ref_module().elastic_update_ref(*jx, eta=ETA, rho=RHO, mu=MU,
                                            n_workers=4)
    eu.fused_elastic_update(*tx, eta=ETA, rho=RHO, mu=MU, n_workers=4)
    tol = 2e-2 if dtype == "bfloat16" else 1e-6
    for got, ref in zip(tx[:2] + tx[3:4], want):
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref, np.float32),
                                   rtol=tol, atol=tol)


_PALLAS_SCRIPT = r"""
import sys
import jax
import jax.experimental
jax.experimental.enable_x64 = jax.enable_x64   # shim: name moved in jax
import jax.numpy as jnp
import numpy as np
from repro.kernels.elastic_update import fused_elastic_update
src, dst = sys.argv[1], sys.argv[2]
data, out = np.load(src), {}
for key in sorted({k.rsplit("_", 1)[0] for k in data.files}):
    n, dt, p = key.split("x")
    xs = [jnp.asarray(data[f"{key}_{i}"], getattr(jnp, dt))
          for i in range(5)]
    block = min(int(n), 4096)
    res = fused_elastic_update(*xs, eta=0.1, rho=0.05, mu=0.9,
                               n_workers=int(p), block=block,
                               interpret=True)
    for name, r in zip("wvc", res):
        out[f"{key}_{name}"] = np.asarray(r, np.float32)
np.savez(dst, **out)
print("PALLAS-OK")
"""

PALLAS_CASES = [(1 << 12, "float32", 4), (1 << 14, "float32", 3),
                (1 << 12, "bfloat16", 4), (1188, "float32", 2)]


def test_plain_update_equals_pallas_kernel_bitwise(tmp_path):
    """The Pallas kernel in interpret mode, under the reference's no-FMA
    pin, through the enable_x64 shim (ROADMAP R1)."""
    src, dst = tmp_path / "in.npz", tmp_path / "out.npz"
    inputs = {}
    for n, dt, p in PALLAS_CASES:
        rng = np.random.RandomState(n + p)
        for i in range(5):
            inputs[f"{n}x{dt}x{p}_{i}"] = rng.randn(n).astype(np.float32)
    np.savez(src, **inputs)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=SSE4_2")
    proc = subprocess.run([sys.executable, "-c", _PALLAS_SCRIPT, str(src),
                           str(dst)], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0 and "PALLAS-OK" in proc.stdout, \
        proc.stderr[-3000:]
    out = np.load(dst)
    for n, dt, p in PALLAS_CASES:
        key = f"{n}x{dt}x{p}"
        # the Pallas kernel computes from the stored (rounded) inputs
        tx = [torch.from_numpy(inputs[f"{key}_{i}"]).to(getattr(torch, dt))
              for i in range(5)]
        eu.fused_elastic_update(*tx, eta=0.1, rho=0.05, mu=0.9, n_workers=p)
        for name, got in zip("wvc", (tx[0], tx[1], tx[3])):
            np.testing.assert_array_equal(got.float().numpy(),
                                          out[f"{key}_{name}"])


@pytest.mark.parametrize("dtypes", [
    ("float32",) * 5, ("float32", "bfloat16", "float32", "bfloat16",
                       "float32"), ("bfloat16",) * 5])
def test_pod_rows_equal_one_dimensional_calls(dtypes):
    """The (P, n) form equals P calls of the 1-D form, each on the
    pre-update center (the center output is the same from every call)."""
    p, n = 3, 1000
    rng = np.random.RandomState(5)
    dw, dv, dg, dc, dm = (getattr(torch, d) for d in dtypes)
    w, v, g = (torch.from_numpy(rng.randn(p, n).astype(np.float32)).to(dt)
               for dt in (dw, dv, dg))
    c, m = (torch.from_numpy(rng.randn(n).astype(np.float32)).to(dt)
            for dt in (dc, dm))
    rows = [(w[i].clone(), v[i].clone(), c.clone()) for i in range(p)]
    eu.fused_elastic_update(w, v, g, c, m, eta=ETA, rho=RHO, mu=MU,
                            n_workers=p)
    for i, (wi, vi, ci) in enumerate(rows):
        eu.fused_elastic_update(wi, vi, g[i], ci, m, eta=ETA, rho=RHO,
                                mu=MU, n_workers=p)
        assert torch.equal(wi, w[i]) and torch.equal(vi, v[i])
        assert torch.equal(ci, c)


@pytest.mark.parametrize("bad", ["f64", "strided", "shape", "center"])
def test_update_wrapper_rejects_bad_rows(bad):
    w, v, g = (torch.zeros(2, 64) for _ in range(3))
    c, m = torch.zeros(64), torch.zeros(64)
    if bad == "f64":
        g = g.double()
    elif bad == "strided":
        v = torch.zeros(2, 128)[:, ::2]
    elif bad == "shape":
        g = torch.zeros(3, 64)
    else:
        c = torch.zeros(63)
    with pytest.raises((TypeError, ValueError)):
        eu.fused_elastic_update(w, v, g, c, m, eta=ETA, rho=RHO, mu=MU,
                                n_workers=2)


def test_cpu_update_counts_no_launch():
    kernels.reset_launch_counts()
    _, tx = _update_inputs(1 << 12, "float32")
    eu.fused_elastic_update(*tx, eta=ETA, rho=RHO, mu=MU, n_workers=2)
    assert kernels.launch_counts()["fused_elastic_update"] == 0


# ---------------------------------------------------------------------------
# compression, schedules and the exchange plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["none", "bf16", "sign_ef"])
def test_compression_encode_decode_match_reference(name):
    rng = np.random.RandomState(11)
    buf, err = (rng.randn(777).astype(np.float32) for _ in range(2))
    ref, port = ref_comp.get(name), compression.get(name)
    assert (port.wire_bytes_per_element, port.jit_wire_bytes_per_element) \
        == (ref.wire_bytes_per_element, ref.jit_wire_bytes_per_element)
    r_pay, r_err = ref.encode(jnp.asarray(buf), jnp.asarray(err))
    p_pay, p_err = port.encode(torch.from_numpy(buf), torch.from_numpy(err))
    np.testing.assert_allclose(p_err.numpy(), np.asarray(r_err), **TOL)
    for a, b in zip(p_pay, r_pay):
        assert str(a.dtype).split(".")[-1] == str(b.dtype)
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32), **TOL)
    np.testing.assert_allclose(
        port.decode_mean(p_pay).numpy(),
        np.asarray(ref.decode_mean(r_pay)), **TOL)


def test_numpy_wire_codecs_match_reference():
    rng = np.random.RandomState(3)
    buf, err = rng.randn(1001), rng.randn(1001) * 0.1
    r_pay, r_err = ref_comp.sign_ef_encode_np(buf, err)
    p_pay, p_err = compression.sign_ef_encode_np(buf, err)
    assert p_pay == r_pay
    np.testing.assert_array_equal(p_err, r_err)
    np.testing.assert_array_equal(compression.sign_ef_decode_np(p_pay),
                                  ref_comp.sign_ef_decode_np(r_pay))
    assert compression.sign_ef_wire_nbytes(1001) == \
        ref_comp.sign_ef_wire_nbytes(1001) == len(p_pay)


_SCHEDULE_SCRIPT = r"""
import sys
from functools import partial
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.comm import schedules
from repro.core import collectives
from repro.utils.jaxcompat import auto_mesh, shard_map
x = np.load(sys.argv[1])["x"]
mesh = auto_mesh((8,), ("x",))
out = {}
for name in schedules.names():
    sched = schedules.get(name)
    @partial(shard_map, mesh=mesh, in_specs=(P("x"),), out_specs=P("x"),
             check_vma=False)
    def run(xs):
        return sched.allreduce(xs[0], "x")[None]
    out[name] = np.asarray(run(jnp.asarray(x)))
    out[name + "_same"] = np.asarray(collectives.shard_map_allreduce(
        mesh, jnp.asarray(x[0]), "x", name))
np.savez(sys.argv[2], **out)
print("SCHED-OK")
"""


@pytest.fixture(scope="module")
def shard_map_sums(tmp_path_factory):
    """Every schedule's ``shard_map`` all-reduce on 8 host devices, over
    distinct rows and over one row broadcast to all 8."""
    tmp = tmp_path_factory.mktemp("sched")
    x = np.random.RandomState(8).randn(8, 203).astype(np.float32)
    np.savez(tmp / "x.npz", x=x)
    proc = subprocess.run(
        [sys.executable, "-c", _SCHEDULE_SCRIPT, str(tmp / "x.npz"),
         str(tmp / "out.npz")], capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=8"))
    assert proc.returncode == 0 and "SCHED-OK" in proc.stdout, \
        proc.stderr[-3000:]
    return x, np.load(tmp / "out.npz")


@pytest.mark.parametrize("name", ["psum", "tree", "butterfly", "ring",
                                  "round_robin", "hierarchical"])
def test_schedule_allreduce_matches_shard_map(shard_map_sums, name):
    x, out = shard_map_sums
    got = schedules.get(name).allreduce(torch.from_numpy(x)).numpy()
    for row in out[name]:                      # every device holds the sum
        np.testing.assert_allclose(got, row, rtol=1e-6)
    same = schedules.get(name).allreduce(
        torch.from_numpy(np.broadcast_to(x[0], x.shape).copy())).numpy()
    np.testing.assert_allclose(same, out[name + "_same"][0], rtol=1e-6)


@pytest.mark.parametrize("name", ["psum", "ring", "round_robin"])
def test_schedule_allreduce_keeps_int8_and_takes_any_shape(name):
    signs = torch.from_numpy(np.random.RandomState(1).choice(
        [-1, 1], size=(3, 5, 7)).astype(np.int8))
    got = schedules.get(name).allreduce(signs)
    assert got.dtype == torch.int8 and got.shape == (5, 7)
    assert torch.equal(got, signs.sum(0).to(torch.int8))
    scales = torch.tensor([0.5, 0.25, 2.0])
    assert schedules.get(name).allreduce(scales).item() == 2.75


@pytest.mark.parametrize("compression_name", ["none", "bf16", "sign_ef"])
@pytest.mark.parametrize("schedule", ["psum", "ring"])
def test_reduce_mean_flat_matches_reference(compression_name, schedule):
    rng = np.random.RandomState(4)
    delta, ef = (rng.randn(3, 300).astype(np.float32) for _ in range(2))
    ref = ref_plan.make_plan(schedule, compression_name, n_total=3)
    port = plan.make_plan(schedule, compression_name, n_total=3)
    r_mean, r_ef = ref.reduce_mean_flat(jnp.asarray(delta), jnp.asarray(ef))
    p_mean, p_ef = port.reduce_mean_flat(torch.from_numpy(delta),
                                         torch.from_numpy(ef))
    tol = dict(rtol=1e-5, atol=1e-6) if compression_name == "sign_ef" \
        else TOL
    mean_tol = tol
    if (schedule, compression_name) == ("ring", "bf16"):
        # the ring adds the bf16 payloads in bf16 at every hop, as the
        # reference's ring_allreduce does on a real pod axis; its local sum
        # here accumulates in f32: a few bf16 ulps of the partial sums
        mean_tol = dict(rtol=0, atol=2 ** -6 * np.abs(delta).max())
    np.testing.assert_allclose(p_mean.numpy(), np.asarray(r_mean),
                               **mean_tol)
    np.testing.assert_allclose(p_ef.numpy(), np.asarray(r_ef), **tol)
    assert port.wire_bytes(1000) == ref.wire_bytes(1000)


def test_exchange_is_the_pod_mean_of_a_pytree():
    rng = np.random.RandomState(6)
    tree = {"w": torch.from_numpy(rng.randn(4, 3, 2).astype(np.float32)),
            "b": (torch.from_numpy(rng.randn(4, 5).astype(np.float32)),)}
    for sched in ("psum", "ring", "butterfly"):
        mean = plan.make_plan(sched, n_total=4).exchange(tree)
        np.testing.assert_allclose(mean["w"].numpy(),
                                   tree["w"].numpy().mean(0), **TOL)
        np.testing.assert_allclose(mean["b"][0].numpy(),
                                   tree["b"][0].numpy().mean(0), **TOL)


def test_make_plan_refuses_pow2_schedule_at_three_pods():
    for name in ("tree", "butterfly", "hierarchical"):
        with pytest.raises(ValueError, match="power-of-two"):
            plan.make_plan(name, n_total=3)
        plan.make_plan(name, n_total=4)
    plan.make_plan("ring", n_total=3)


def test_plan_costs_match_reference():
    from repro.core import costmodel as ref_cost
    from repro_torch.core import costmodel
    for name in ("psum", "ring", "butterfly"):
        for comp in ("none", "sign_ef"):
            ref = ref_plan.make_plan(name, comp, overlap=True, n_total=4)
            port = plan.make_plan(name, comp, overlap=True, n_total=4)
            assert port.cost_s(10**6, costmodel.PS_WIRE) == pytest.approx(
                ref.cost_s(10**6, ref_cost.PS_WIRE), rel=1e-12)
            assert port.visible_cost_s(
                10**6, costmodel.PS_WIRE, 1e-3) == pytest.approx(
                ref.visible_cost_s(10**6, ref_cost.PS_WIRE, 1e-3), rel=1e-12)


# ---------------------------------------------------------------------------
# apply_gradients against the reference's
# ---------------------------------------------------------------------------

def _tree(rng, pods=None):
    lead = () if pods is None else (pods,)
    return {"w": jnp.asarray(rng.randn(*lead, 3, 4), jnp.float32),
            "b": (jnp.asarray(rng.randn(*lead, 4), jnp.float32),
                  jnp.asarray(rng.randn(*lead, 2, 2), jnp.float32))}


def _ref_apply(cfg, packed):
    """The reference's apply_gradients, jitted once per config (packed:
    its shard_map body on a one-device mesh)."""
    if not packed:
        return jax.jit(lambda s, g: ref_elastic.apply_gradients(s, g, cfg))
    mesh = auto_mesh((1, 1), ("data", "model"))

    def apply(state, grads):
        specs = jax.tree_util.tree_map(lambda x: P(), state.center
                                       if state.center is not None else
                                       jax.tree_util.tree_map(
                                           lambda x: x[0], grads))
        return ref_elastic.apply_gradients(state, grads, cfg, mesh=mesh,
                                           param_specs=specs, pod_axis=None)
    return jax.jit(apply)


def _rows(tree):
    return elastic.state_from_jax(ref_elastic.ElasticState(
        0, _np(tree), _np(tree), None, None), device="cpu").params


def _assert_states_close(port, ref, tol=TOL):
    want = elastic.state_from_jax(_np(ref), device="cpu")
    assert port.step == want.step
    for name in ("params", "momentum", "center", "ef_error"):
        a, b = getattr(port, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype, name
            np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                       err_msg=name, **tol)


def _run_both(ref_cfg, port_cfg, n_pods, steps=1, packed=True, seed=0):
    """``steps`` steps of both from the same state and gradients."""
    rng = np.random.RandomState(seed)
    params = _tree(rng)
    ref_state = ref_elastic.init(params, ref_cfg, n_pods)
    # spread the pods so the exchange has something to average
    ref_state = ref_state._replace(params=jax.tree_util.tree_map(
        lambda x: x + jnp.asarray(rng.randn(*x.shape), x.dtype) * 0.1,
        ref_state.params))
    port_state = elastic.state_from_jax(_np(ref_state), device="cpu")
    ref_apply = _ref_apply(ref_cfg, packed)
    for _ in range(steps):
        grads = _tree(rng, n_pods)
        ref_state = ref_apply(ref_state, grads)
        port_state = elastic.apply_gradients(port_state, _rows(grads),
                                             port_cfg)
    return port_state, ref_state


def _cfgs(**kw):
    easgd = kw.pop("easgd", dict(eta=ETA, rho=RHO, mu=MU))
    return (ref_elastic.ElasticConfig(easgd=RefEASGD(**easgd), **kw),
            elastic.ElasticConfig(easgd=EASGDConfig(**easgd), **kw))


@pytest.mark.parametrize("n_pods", [1, 2, 3])
@pytest.mark.parametrize("compression_name", ["none", "bf16", "sign_ef"])
def test_packed_apply_gradients_matches_reference(n_pods, compression_name):
    ref_cfg, port_cfg = _cfgs(compression=compression_name)
    port, ref = _run_both(ref_cfg, port_cfg, n_pods, steps=3)
    tol = dict(rtol=1e-5, atol=1e-6) if compression_name == "sign_ef" \
        else TOL
    _assert_states_close(port, ref, tol)


@pytest.mark.parametrize("n_pods", [1, 3])
def test_unpacked_apply_gradients_matches_reference(n_pods):
    ref_cfg, port_cfg = _cfgs(packed=False)
    port, ref = _run_both(ref_cfg, port_cfg, n_pods, steps=2, packed=False)
    _assert_states_close(port, ref)


def test_bf16_momentum_and_center_match_reference():
    """The stored dtypes of the spec fields: the packed update rounds V', W'
    and C' once each, from f32 math, on both sides."""
    ref_cfg, port_cfg = _cfgs(momentum_dtype=jnp.bfloat16,
                              center_dtype=jnp.bfloat16)
    port_cfg = dataclasses.replace(port_cfg, momentum_dtype=torch.bfloat16,
                                   center_dtype=torch.bfloat16)
    port, ref = _run_both(ref_cfg, port_cfg, 2, steps=2)
    assert port.momentum.dtype == port.center.dtype == torch.bfloat16
    # one bf16 rounding may land on either side of a tie
    _assert_states_close(port, ref, dict(rtol=1e-2, atol=1e-2))


def test_tau_and_msgd_match_reference():
    easgd = dict(eta=ETA, rho=RHO, mu=MU, tau=3)
    ref_cfg, port_cfg = _cfgs(easgd=easgd)
    port, ref = _run_both(ref_cfg, port_cfg, 2, steps=4)
    _assert_states_close(port, ref)
    ref_cfg, port_cfg = _cfgs(mode="msgd")
    port, ref = _run_both(ref_cfg, port_cfg, 3, steps=2)
    assert port.center is None and port.ef_error is None
    _assert_states_close(port, ref)


def test_ring_schedule_exchange_matches_reference():
    ref_cfg, port_cfg = _cfgs(schedule="ring")
    port, ref = _run_both(ref_cfg, port_cfg, 3, steps=2)
    _assert_states_close(port, ref)


@pytest.mark.parametrize("nesterov", [False, True])
def test_update_rules_match_reference(nesterov):
    """The pytree rules of ``core.easgd`` and ``fused_elastic_step_flat``
    on the same inputs as the reference's."""
    from repro.core import easgd as ref_easgd
    from repro_torch.core import easgd
    rng = np.random.RandomState(9)
    w, v, g, c = (_tree(rng) for _ in range(4))
    kw = dict(eta=ETA, rho=RHO, mu=MU, nesterov=nesterov)
    ref_cfg, port_cfg = RefEASGD(**kw), EASGDConfig(**kw)

    def port(tree):
        return jax.tree_util.tree_map(
            lambda x: torch.from_numpy(np.array(x)), tree)

    calls = [("sgd_update", (w, g)), ("msgd_update", (w, v, g)),
             ("easgd_worker_update", (w, g, c)),
             ("measgd_worker_update", (w, v, g, c)),
             ("center_update_single", (c, w)),
             ("center_update_from_sum", (c, w, 3)),
             ("center_update_from_mean", (c, w, 3)),
             ("fused_elastic_step_flat", tuple(
                 jnp.asarray(rng.randn(50), jnp.float32) for _ in range(5))
              + (3,))]
    for name, args in calls:
        want = getattr(ref_easgd, name)(*args, ref_cfg)
        got = getattr(easgd, name)(*(a if isinstance(a, int) else port(a)
                                     for a in args), port_cfg)
        want, got = (jax.tree_util.tree_leaves(t) for t in (want, got))
        assert len(got) == len(want), name
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       err_msg=name, **TOL)


# -- the reference's own property tests (tests/test_easgd_core.py), ported --

def _port_state(params: dict, cfg, n_pods):
    return elastic.init({k: torch.as_tensor(v) for k, v in params.items()},
                        cfg, n_pods)


def test_packed_equals_unpacked():
    cfg_u = elastic.ElasticConfig(easgd=EASGDConfig(eta=0.05, rho=0.1,
                                                    mu=0.9), packed=False)
    cfg_p = dataclasses.replace(cfg_u, packed=True)
    params = {"w": torch.arange(12.0).reshape(3, 4) / 10,
              "b": torch.ones(4)}
    grads = torch.full((2, 16), 0.2)
    grads[0] = -0.1
    out_u = elastic.apply_gradients(_port_state(params, cfg_u, 2),
                                    grads.clone(), cfg_u)
    out_p = elastic.apply_gradients(_port_state(params, cfg_p, 2),
                                    grads.clone(), cfg_p)
    np.testing.assert_allclose(out_u.params.numpy(), out_p.params.numpy(),
                               **TOL)
    np.testing.assert_allclose(out_u.center.numpy(), out_p.center.numpy(),
                               **TOL)


def test_tau_period():
    """τ=3: the center only moves on steps 0, 3, 6, …"""
    cfg = elastic.ElasticConfig(easgd=EASGDConfig(eta=0.1, rho=0.1, mu=0.0,
                                                  tau=3))
    state = _port_state({"w": torch.ones(2, 2)}, cfg, 2)
    state = dataclasses.replace(state, params=state.params
                                + torch.tensor([[0.5], [-0.1]]))
    grads = torch.stack([torch.full((4,), 1.0), torch.full((4,), -0.4)])
    centers = []
    for _ in range(6):
        state = elastic.apply_gradients(state, grads, cfg)
        centers.append(state.center.clone())
    assert torch.equal(centers[1], centers[0])
    assert torch.equal(centers[2], centers[1])
    assert not torch.equal(centers[3], centers[2])
    assert state.step == 6


def test_sign_ef_error_feedback_stays_bounded():
    cfg = elastic.ElasticConfig(easgd=EASGDConfig(eta=0.2, rho=0.5, mu=0.0),
                                compression="sign_ef")
    state = _port_state({"w": torch.zeros(16)}, cfg, 2)
    grads = torch.stack([torch.ones(16), -torch.ones(16)])
    for _ in range(10):
        state = elastic.apply_gradients(state, grads, cfg)
    assert bool((state.center.abs() < 1.0).all())
    assert bool(torch.isfinite(state.ef_error).all())


def test_consensus_contraction():
    """Zero gradients: workers and center contract toward each other."""
    cfg = elastic.ElasticConfig(easgd=EASGDConfig(eta=0.5, rho=0.5, mu=0.0))
    state = _port_state({"w": torch.zeros(8)}, cfg, 3)
    state.params.copy_(torch.stack([torch.full((8,), -1.0), torch.zeros(8),
                                    torch.full((8,), 1.0)]))

    def spread(s):
        return float((s.params - s.center[None]).abs().max())

    s0 = spread(state)
    for _ in range(5):
        state = elastic.apply_gradients(state, torch.zeros(3, 8), cfg)
    assert spread(state) < s0


def test_auto_schedule_resolves_from_the_packed_bytes():
    """"auto" resolves the reference's schedule by name over P ∈ {2, 3,
    4, 8, 16} and packed sizes of 2^8 … 2^33 bytes (130 cells), so both
    sum the pod rows in the same order. Priced on the port's default
    network instead, three cells differed: (P 4, 512 KiB), (8, 1 MiB) and
    (16, 1 MiB), butterfly in the reference and ring in the port."""
    cfg = elastic.ElasticConfig(schedule="auto")
    ref = ref_elastic.ElasticConfig(schedule="auto")
    differ = []
    for p in (2, 3, 4, 8, 16):
        for k in range(8, 34):
            n_el = 2**k // 4                       # f32 pod rows
            got = cfg.resolve_schedule(p, n_el)
            want = ref.resolve_schedule(p, n_el)
            if got != want:
                differ.append((p, 2**k, want, got))
    assert not differ, f"(P, bytes, reference, port): {differ}"
    sign = elastic.ElasticConfig(schedule="auto", compression="sign_ef")
    ref_sign = ref_elastic.ElasticConfig(schedule="auto",
                                         compression="sign_ef")
    assert sign.resolve_schedule(1, 10**6) == "psum"
    assert sign.resolve_schedule(4) == "psum"
    name = sign.resolve_schedule(4, 10**6)
    assert name == ref_sign.resolve_schedule(4, 10**6)
    assert sign.exchange_plan(4, 10**6).schedule.name == name

"""``launch.opcount``: the port's counterpart of ``repro.launch.hloparse``.

FLOPs and bytes of plain aten chains, each hand-written kernel's region
(its formula once, none of its plain version's ops), the collectives of
the port on an in-process fake world of 8 ranks, and ``MemTracker``'s peak
under fake tensors against the same step on real CPU tensors."""
import pytest
import torch

from repro_torch import configs
from repro_torch.comm import plan as comm_plan
from repro_torch.core import costmodel as cm
from repro_torch.kernels import elastic_update as eu
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_ce as ce
from repro_torch.kernels import ssd_chunk as sc
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.opcount import OpCounter
from repro_torch.models import tp
from repro_torch.utils import opcount_hook


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def test_aten_chain_flops_and_bytes():
    g = torch.Generator().manual_seed(0)
    a = torch.randn(8, 16, generator=g)
    b = torch.randn(16, 4, generator=g)
    c = torch.randn(3, 4, 5, generator=g)
    d = torch.randn(3, 5, 6, generator=g)
    bias = torch.randn(4, generator=g)
    with OpCounter() as k:
        y = a @ b                        # mm
        z = torch.bmm(c, d)              # bmm
        w = torch.addmm(bias, a, b)      # addmm
        v = y.t()                        # a view: no bytes
        s = (y + w).relu()               # add, relu
    costs = k.costs()
    assert costs.flops == 2 * 8 * 16 * 4 + 2 * 3 * 4 * 5 * 6 + 2 * 8 * 16 * 4
    assert costs.bytes == (_nbytes(a, b, y) + _nbytes(c, d, z)
                           + _nbytes(bias, a, b, w) + _nbytes(y, w, y + w)
                           + 2 * _nbytes(s))
    assert v.shape == (4, 8) and costs.regions == {}
    assert costs.collective_bytes == 0 and opcount_hook.active() is None


def test_composites_count_under_inference_mode():
    """Without autograd (serving's ``inference_mode``) einsum and matmul
    reach the counter whole: it counts what they decompose into, the
    same FLOPs as with autograd on."""
    g = torch.Generator().manual_seed(2)
    a = torch.randn(2, 8, 16, generator=g)
    b = torch.randn(16, 4, generator=g)
    counts = []
    for mode in (torch.inference_mode, torch.enable_grad):
        with mode(), OpCounter() as k:
            torch.einsum("bsd,dk->bsk", a, b)
            torch.matmul(a, b)
        counts.append(k.costs().flops)
    assert counts == [2 * (2 * 2 * 8 * 16 * 4)] * 2


def _inputs():
    g = torch.Generator().manual_seed(1)

    def r(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(dtype)
    bf = torch.bfloat16
    q, k, v = r(2, 24, 4, 16, dtype=bf), r(2, 24, 2, 16, dtype=bf), \
        r(2, 24, 2, 8, dtype=bf)
    out, lse = fa.flash_attention_fwd(q, k, v, True, 8)
    h, w = r(40, 16, dtype=bf), r(16, 300, dtype=bf)
    y = torch.randint(0, 300, (40,), generator=g)
    loss, lse_ce, _ = ce.fused_ce_fwd(h, w, y)
    a, x = -r(6, 32).abs(), r(6, 32, 8)
    bb, cc = r(2, 32, 4), r(2, 32, 4)
    P, n = 2, 1000
    return {
        "flash_attention_fwd": ((q, k, v, True, 8), {},
                                cm.attention_fwd_work(2, 24, 4, 2, 16, 8,
                                                      True, 8, 2)),
        "flash_attention_bwd": ((q, k, v, out, lse, r(2, 24, 4, 8, dtype=bf),
                                 True, 8), {},
                                cm.attention_bwd_work(2, 24, 4, 2, 16, 8,
                                                      True, 8, 2)),
        "fused_ce_fwd": ((h, w, y), {}, cm.ce_fwd_work(40, 16, 300, 2)),
        "fused_ce_bwd": ((h, w, y, lse_ce, torch.ones(40)), {},
                         cm.ce_bwd_work(40, 16, 300, 2)),
        "ssd_intra_fwd": ((a, x, bb, cc, 16), {},
                          cm.ssd_fwd_work(2, 3, 32, 8, 4, 16)),
        "ssd_intra_bwd": ((a, x, bb, cc, r(6, 32, 8), 16), {},
                          cm.ssd_bwd_work(2, 3, 32, 8, 4, 16)),
        "fused_elastic_update": (
            (r(P, n), r(P, n, dtype=bf), r(P, n), r(n, dtype=bf), r(n)),
            dict(eta=0.1, rho=0.1, mu=0.9, n_workers=P),
            cm.elastic_update_work(P, n, (4, 2, 4, 2, 4))),
    }


WRAPPERS = {"flash_attention_fwd": fa, "flash_attention_bwd": fa,
            "fused_ce_fwd": ce, "fused_ce_bwd": ce, "ssd_intra_fwd": sc,
            "ssd_intra_bwd": sc, "fused_elastic_update": eu}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_kernel_region_counts_its_formula_once(name):
    """The region adds the formula's bytes and operations once, and none
    of the plain version's ops that run inside it; outside a counter the
    wrapper runs as it did."""
    args, kw, (n_bytes, n_ops) = _inputs()[name]
    fn = getattr(WRAPPERS[name], name)
    plain = getattr(WRAPPERS[name], name + "_ref")
    assert fn.__name__ == name and hasattr(fn, "launches")
    clones = [a.clone() if isinstance(a, torch.Tensor) else a for a in args]
    with OpCounter() as k:
        got = fn(*args, **kw)
    costs = k.costs()
    assert costs.regions == {name: {"launches": 1, "bytes": n_bytes,
                                    "operations": n_ops}}
    assert (costs.bytes, costs.flops) == (n_bytes, n_ops)
    want = plain(*clones, **kw)
    if got is not None:
        for g_, w_ in zip(got, want):
            assert torch.equal(g_, w_)


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_stand_in_makes_the_kernels_outputs(name):
    """With stand-ins the region runs nothing: same shapes and dtypes as
    the plain version's outputs, and the same count."""
    args, kw, (n_bytes, n_ops) = _inputs()[name]
    fn = getattr(WRAPPERS[name], name)
    want = fn(*[a.clone() if isinstance(a, torch.Tensor) else a
                for a in args], **kw)
    with OpCounter(stand_ins=True) as k:
        got = fn(*args, **kw)
    assert (k.costs().bytes, k.costs().flops) == (n_bytes, n_ops)
    if want is None:
        assert got is None
    else:
        assert [(t.shape, t.dtype) for t in got] == \
            [(t.shape, t.dtype) for t in want]


@pytest.fixture
def world_of_8():
    with dryrun.fake_world(8):
        yield make_host_mesh(2, 2, 2, device="cpu")


def test_collectives_by_kind_dtype_and_pod(world_of_8):
    """(pod 2, data 2, model 2) on a fake world: the model-parallel
    all-reduce, the FSDP gather and its reduce-scatter, the vocab-parallel
    CE's three all-reduces, and the pod group's psum and ring rounds are
    counted by kind and dtype; only the pod group's cross pods."""
    mesh = world_of_8
    model, data, pod = (mesh.get_group(a) for a in ("model", "data", "pod"))
    x = torch.ones(4, 6, dtype=torch.bfloat16)
    with OpCounter(pod_stride=4) as k:
        tp._all_reduce(x, model)                              # 48 B
        g = tp.all_gather(torch.ones(3, 5, requires_grad=True), 0, data)
        g.sum().backward()                                    # 120 + 60 B
        h = torch.ones(4, 8, requires_grad=True)
        loss, _ = ce.vocab_parallel_cross_entropy(
            h, torch.ones(8, 10), torch.zeros(4, dtype=torch.int64), 0,
            model)                                            # 32+32+32 B
        row = torch.ones(2, 100)
        comm_plan.make_plan("psum", n_total=2, group=pod).reduce_mean_flat(
            row)                                              # 400 B
        comm_plan._ring_allreduce(torch.ones(100), pod)       # 2 x 200 B
    c = k.costs()
    assert c.counts_by_collective == {"all-reduce": 5, "all-gather": 1,
                                      "reduce-scatter": 1,
                                      "collective-permute": 2}
    assert c.bytes_by_collective == {"all-reduce": 48 + 96 + 400,
                                     "all-gather": 120,
                                     "reduce-scatter": 60,
                                     "collective-permute": 400}
    assert c.collective_bytes_by_dtype == {"bf16": 48, "f32": 120 + 60 + 64
                                           + 400 + 400, "s64": 32}
    assert c.cross_pod_bytes == 800
    assert c.cross_pod_bytes_by_dtype == {"f32": 800}
    assert loss.shape == (4,)


def test_no_counter_no_change(world_of_8):
    """Without a counter the hook is inert and the wrappers run as they
    did."""
    assert opcount_hook.active() is None
    with OpCounter() as outer:
        assert opcount_hook.active() is outer
    assert opcount_hook.active() is None
    out = tp._all_reduce(torch.ones(3), world_of_8.get_group("model"))
    assert torch.equal(out, torch.ones(3))


def test_memtracker_peak_fake_equals_real():
    """The dry run's peak under fake tensors equals MemTracker's peak on
    the same small step on real CPU tensors, and so do the counts."""
    spec = configs.get("gemma3-4b")
    ecfg = dryrun.make_elastic_config(spec)

    def prepare():
        return dryrun.train_step(spec.reduced, ecfg, n_pods=2,
                                 per_pod_batch=2, seq=16, microbatches=2)
    fake, fake_peak = dryrun.count_step(prepare, fake=True)
    real, real_peak = dryrun.count_step(prepare, fake=False)
    assert fake_peak == real_peak > 0
    assert (fake.flops, fake.bytes, fake.launches) == \
        (real.flops, real.bytes, real.launches)
    n_layers = spec.reduced.n_layers
    assert fake.launches["flash_attention_bwd"] == 2 * 2 * n_layers
    assert fake.launches["fused_elastic_update"] == 1

"""The port on the card: its CUDA kernels against their plain versions (bit
for bit for the f64 updates, at the stated tolerances for attention,
cross-entropy and the SSD block), the runtime's card runs against its CPU
runs, and the LMs' gradients through the kernels. Every test is marked
``cuda`` and skips without a GPU.

This file imports only torch, numpy and the port, so it runs on a machine
without JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The oracles are the plain versions and the CPU paths, which
tests/test_torch_{elastic_update,ps,attention,fused_ce,lm,ssd,ssm}.py hold
against the reference.
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core.easgd import EASGDConfig
from repro_torch.kernels import elastic_update as eu
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_ce, ssd_chunk
from repro_torch import configs
from repro_torch.core import elastic
from repro_torch.ps import problems, runtime, zoo
from repro_torch.runtime.train import build_train_step

ETA, RHO, MU = 0.05, 0.07, 0.9


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _rows(n, p, device):
    rng = np.random.RandomState(n * 10 + p)
    w, g, c, r, v = (torch.from_numpy(rng.randn(n)).to(device)
                     for _ in range(5))
    return {"w": w, "g": g, "c": c, "r": r * p, "v": v}


def _update_both(d, p):
    """Both fused updates on copies of ``d``; returns the outputs."""
    w, c_out = d["w"].clone(), torch.empty_like(d["c"])
    eu.fused_sync_easgd_update(w, d["g"], d["c"], d["r"], p, ETA, RHO,
                               center_out=c_out)
    w_solo = d["w"].clone()
    eu.fused_sync_easgd_update(w_solo, d["g"], d["c"], d["r"], p, ETA, RHO)
    c, v = d["c"].clone(), d["v"].clone()
    eu.fused_sync_sgd_update(c, v, d["r"], p, ETA, MU)
    return [t.cpu() for t in (w, c_out, w_solo, c, v)]


def _counts(**launched):
    return {k.__name__: launched.get(k.__name__, 0) for k in kernels.KERNELS}


@pytest.mark.cuda
@pytest.mark.parametrize("n,p", [(1188, 3), (4096, 4), (131072 + 777, 3)])
def test_cuda_kernels_equal_cpu_plain_versions(cuda, n, p):
    kernels.reset_launch_counts()
    on_card = _update_both(_rows(n, p, cuda), p)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == _counts(fused_sync_easgd_update=2,
                                              fused_sync_sgd_update=1)
    on_cpu = _update_both(_rows(n, p, "cpu"), p)
    for got, want in zip(on_card, on_cpu):
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["sync_easgd", "sync_sgd"])
def test_cuda_run_equals_cpu_run(cuda, algo):
    cfg = runtime.PSConfig(algorithm=algo, n_workers=3, total_iters=36,
                           eval_every_iters=10**9, bucket_bytes=256)
    easgd = EASGDConfig(eta=ETA, rho=RHO, mu=MU)
    kernels.reset_launch_counts()
    gpu = runtime.run_ps(problems.NUMPY_MLP, easgd, cfg, device=cuda)
    launched = kernels.launch_counts()
    cpu = runtime.run_ps(problems.NUMPY_MLP, easgd, cfg, device="cpu")
    assert torch.equal(gpu.center.cpu(), cpu.center)
    assert torch.equal(gpu.workers.cpu(), cpu.workers)
    assert gpu.counters == cpu.counters
    rounds = 36 // 3
    assert launched == (_counts(fused_sync_easgd_update=3 * rounds)
                        if algo == "sync_easgd"
                        else _counts(fused_sync_sgd_update=rounds))


# limits on the relative norm ||kernel - plain|| / ||plain||, as
# chip_smoke.py holds them: f32 outputs at the f32 tolerances of
# tests/test_kernels.py (forward, backward), bf16 outputs at 1e-2
LIMIT = {"fwd": 1e-5, "bwd": 1e-4, "bf16": 1e-2}


def _close(got, want, kind):
    limit = LIMIT["bf16" if got.dtype == torch.bfloat16 else kind]
    rel = float((got.float() - want.float()).norm() / want.float().norm())
    assert rel <= limit, f"relative norm {rel:.3e} > limit {limit:g}"


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KVH,D,causal,window,dtype", [
    (1, 100, 4, 2, 16, True, 9, torch.float32),
    (1, 70, 2, 2, 32, False, 0, torch.float32),
    (2, 130, 4, 2, 64, True, 0, torch.bfloat16),
    (1, 200, 8, 4, 256, True, 64, torch.bfloat16),
    (1, 96, 4, 1, 128, True, 0, torch.float32),
    (2, 24, 4, 2, 16, True, 8, torch.bfloat16),     # reduced gemma3-4b
    (1, 100, 4, 2, 32, True, 0, torch.bfloat16),
    (2, 150, 4, 2, 128, True, 48, torch.bfloat16),
    (1, 77, 4, 4, 64, False, 0, torch.bfloat16),    # ragged, no mask
    # head dims on the next tile width up: 24 (reduced gemma3-27b) on the
    # 32-column tiles, 96 (phi3-mini) on the 128-column ones
    (2, 130, 4, 2, 24, True, 8, torch.bfloat16),
    (1, 100, 4, 2, 24, True, 0, torch.float32),
    (1, 200, 4, 4, 96, True, 0, torch.bfloat16),
    (1, 150, 4, 2, 96, False, 0, torch.bfloat16),
    (1, 90, 2, 2, 96, True, 48, torch.float32),
])
def test_attention_kernels_match_plain_versions(cuda, B, S, H, KVH, D,
                                                causal, window, dtype):
    rng = np.random.RandomState(S + D)
    q, k, v, do = (torch.from_numpy(rng.randn(B, S, h, D).astype(
        np.float32)).to(cuda, dtype) for h in (H, KVH, KVH, H))
    kernels.reset_launch_counts()
    out, lse = fa.flash_attention_fwd(q, k, v, causal, window)
    grads = fa.flash_attention_bwd(q, k, v, out, lse, do, causal, window)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == _counts(flash_attention_fwd=1,
                                              flash_attention_bwd=1)
    p_out, p_lse = fa.flash_attention_fwd_ref(q, k, v, causal, window)
    _close(out, p_out, "fwd")
    _close(lse, p_lse, "fwd")
    p_grads = fa.flash_attention_bwd_ref(q, k, v, out, lse, do, causal,
                                         window)
    for g, w in zip(grads, p_grads):
        assert g.dtype == dtype
        _close(g, w, "bwd")


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 256])
def test_attention_backward_gives_the_same_bits_twice(cuda, window):
    """The bf16 backward sums dk / dv over the G heads and the q tiles in
    a fixed order, without atomics."""
    rng = np.random.RandomState(7 + window)
    q, k, v, do = (torch.from_numpy(rng.randn(1, 1024, h, 256).astype(
        np.float32)).to(cuda, torch.bfloat16) for h in (8, 4, 4, 8))
    out, lse = fa.flash_attention_fwd(q, k, v, True, window)
    first = fa.flash_attention_bwd(q, k, v, out, lse, do, True, window)
    again = fa.flash_attention_bwd(q, k, v, out, lse, do, True, window)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("D,dtype", [
    (24, torch.bfloat16), (24, torch.float32),
    (96, torch.bfloat16), (96, torch.float32)])
def test_padded_head_dims_read_only_their_own_columns(cuda, D, dtype):
    """At D 24 and 96 the kernels run on wider tiles. The same inputs laid
    in larger buffers whose tail holds a large value give the same bits:
    no load reads past a (B, S, heads, D) tensor. The backward twice gives
    the same bits."""
    rng = np.random.RandomState(D)
    B, S, H, KVH = 1, 160, 4, 2
    xs = [torch.from_numpy(rng.randn(B, S, h, D).astype(np.float32)).to(
        cuda, dtype) for h in (H, KVH, KVH, H)]
    out, lse = fa.flash_attention_fwd(*xs[:3], True, 0)
    first = fa.flash_attention_bwd(*xs[:3], out, lse, xs[3], True, 0)
    views = []
    for x in xs:
        buf = torch.full((x.numel() + 4096,), 1e4, dtype=dtype, device=cuda)
        views.append(buf[:x.numel()].view(x.shape).copy_(x))
    out2, lse2 = fa.flash_attention_fwd(*views[:3], True, 0)
    again = fa.flash_attention_bwd(*views[:3], out2, lse2, views[3], True,
                                   0)
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


# MLA's head-dim pairs: q / k at D, v / out / dout at Dv. (192, 128) is
# deepseek-v2-236b at full width (on the 256- and 128-column tiles), (24,
# 16) the reduced deepseek-v2 (on the 32- and 16-column ones)
MLA_CASES = [(b, s, h, kvh, d, dv, causal, window, dtype)
             for b, s, h, kvh, d, dv in ((1, 300, 4, 4, 192, 128),
                                         (2, 130, 4, 2, 24, 16))
             for causal, window in ((True, 0), (True, 48), (False, 0))
             for dtype in (torch.bfloat16, torch.float32)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KVH,D,Dv,causal,window,dtype", MLA_CASES)
def test_attention_kernels_at_a_v_head_dim_apart(cuda, B, S, H, KVH, D, Dv,
                                                 causal, window, dtype):
    """Dv != D: out and dv come back at Dv, dq and dk at D, each held to
    its plain version; the backward twice gives the same bits."""
    rng = np.random.RandomState(S + D + Dv)
    q, k, v, do = (torch.from_numpy(rng.randn(B, S, h, w).astype(
        np.float32)).to(cuda, dtype)
        for h, w in ((H, D), (KVH, D), (KVH, Dv), (H, Dv)))
    kernels.reset_launch_counts()
    out, lse = fa.flash_attention_fwd(q, k, v, causal, window)
    grads = fa.flash_attention_bwd(q, k, v, out, lse, do, causal, window)
    again = fa.flash_attention_bwd(q, k, v, out, lse, do, causal, window)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == _counts(flash_attention_fwd=1,
                                              flash_attention_bwd=2)
    assert out.shape == (B, S, H, Dv)
    p_out, p_lse = fa.flash_attention_fwd_ref(q, k, v, causal, window)
    _close(out, p_out, "fwd")
    _close(lse, p_lse, "fwd")
    p_grads = fa.flash_attention_bwd_ref(q, k, v, out, lse, do, causal,
                                         window)
    for g, a, w, x in zip(grads, again, p_grads, (q, k, v)):
        assert g.dtype == dtype and g.shape == x.shape
        _close(g, w, "bwd")
        assert torch.equal(g, a)


@pytest.mark.cuda
@pytest.mark.parametrize("D,Dv", [(192, 64), (128, 192), (96, 64)])
def test_attention_refuses_an_uninstantiated_pair(cuda, D, Dv):
    """A pair outside HEAD_DIM_PAIRS raises on the card: no plain
    version runs in its place."""
    q, k = (torch.zeros(1, 64, 2, D, dtype=torch.bfloat16, device=cuda)
            for _ in range(2))
    v = torch.zeros(1, 64, 2, Dv, dtype=torch.bfloat16, device=cuda)
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="head_dim pair"):
        fa.flash_attention_fwd(q, k, v)
    lse = torch.zeros(1, 64, 2, device=cuda)
    with pytest.raises(ValueError, match="head_dim pair"):
        fa.flash_attention_bwd(q, k, v, v, lse, v)
    assert kernels.launch_counts() == _counts()


@pytest.mark.cuda
def test_attention_refuses_unaligned_bf16(cuda):
    B, S, H, D = 1, 32, 2, 64
    q = torch.zeros(B * S * H * D + 1, dtype=torch.bfloat16, device=cuda)
    q = q[1:].view(B, S, H, D)                      # 2 bytes off
    k = torch.zeros(B, S, H, D, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="tensor cores"):
        fa.flash_attention_fwd(q, k, k)
    lse = torch.zeros(B, S, H, device=cuda)
    with pytest.raises(ValueError, match="tensor cores"):
        fa.flash_attention_bwd(k, k, k, k, lse, q)


@pytest.mark.cuda
@pytest.mark.parametrize("T,d,V,dtype", [
    (100, 16, 300, torch.float32),
    (257, 32, 130, torch.float32),
    (64, 64, 1000, torch.bfloat16),     # tensor cores; ragged vocab tile
    (256, 48, 520, torch.bfloat16),     # whole token tiles on both sides
    (48, 64, 512, torch.bfloat16),      # reduced gemma3-4b's loss head
    (200, 64, 50280, torch.bfloat16),   # mamba2's vocab, a ragged token tile
    (130, 32, 100, torch.bfloat16),     # a vocabulary below one tile
])
@pytest.mark.parametrize("chunk", ["one", "many"])
def test_cross_entropy_kernels_match_plain_versions(cuda, monkeypatch, T,
                                                    d, V, dtype, chunk):
    """``many``: the bf16 backward's vocab chunk cut to one 256-column tile,
    so that dh joins its f32 sum over several chunks, the last ragged."""
    if chunk == "many":
        monkeypatch.setattr(fused_ce, "_CHUNK_BYTES", 1)
    rng = np.random.RandomState(T + V)
    h = torch.from_numpy(rng.randn(T, d).astype(np.float32)).to(cuda, dtype)
    w = torch.from_numpy((rng.randn(d, V) * 0.1).astype(np.float32)).to(
        cuda, dtype)
    t = torch.from_numpy(rng.randint(0, V, size=T)).to(cuda)
    g = torch.from_numpy(rng.rand(T).astype(np.float32)).to(cuda)
    kernels.reset_launch_counts()
    loss, lse, pred = fused_ce.fused_ce_fwd(h, w, t)
    dh, dw = fused_ce.fused_ce_bwd(h, w, t, lse, g)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == _counts(fused_ce_fwd=1,
                                              fused_ce_bwd=1)
    p_loss, p_lse, p_pred = fused_ce.fused_ce_fwd_ref(h, w, t)
    _close(loss, p_loss, "fwd")
    _close(lse, p_lse, "fwd")
    assert torch.equal(pred, p_pred)
    p_dh, p_dw = fused_ce.fused_ce_bwd_ref(h, w, t, lse, g)
    assert dh.dtype == dw.dtype == dtype
    _close(dh, p_dh, "bwd")
    _close(dw, p_dw, "bwd")


@pytest.mark.cuda
@pytest.mark.parametrize("chunk_bytes", [1, 1 << 29])
def test_cross_entropy_backward_gives_the_same_bits_twice(cuda, monkeypatch,
                                                          chunk_bytes):
    """No atomics: every output element of the bf16 backward has one owner,
    and dh sums its chunks in a fixed order."""
    monkeypatch.setattr(fused_ce, "_CHUNK_BYTES", chunk_bytes)
    rng = np.random.RandomState(3)
    T, d, V = 300, 256, 3000
    h = torch.from_numpy(rng.randn(T, d).astype(np.float32)).to(
        cuda, torch.bfloat16)
    w = torch.from_numpy((rng.randn(d, V) * 0.2).astype(np.float32)).to(
        cuda, torch.bfloat16)
    t = torch.from_numpy(rng.randint(0, V, size=T)).to(cuda)
    g = torch.from_numpy(rng.rand(T).astype(np.float32)).to(cuda)
    _, lse, _ = fused_ce.fused_ce_fwd(h, w, t)
    first = fused_ce.fused_ce_bwd(h, w, t, lse, g)
    again = fused_ce.fused_ce_bwd(h, w, t, lse, g)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["d", "unaligned"])
def test_cross_entropy_refuses_rows_the_tensor_cores_cannot_take(cuda, bad):
    d = 24 if bad == "d" else 32
    h = torch.zeros(65, d, dtype=torch.bfloat16, device=cuda)
    if bad == "unaligned":
        h = h.view(-1)[1:1 + 64 * d].view(64, d)    # 2 bytes off
    w = torch.zeros(d, 300, dtype=torch.bfloat16, device=cuda)
    t = torch.zeros(h.shape[0], dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="tensor cores"):
        fused_ce.fused_ce_fwd(h, w, t)
    with pytest.raises(ValueError, match="tensor cores"):
        fused_ce.fused_ce_bwd(h, w, t, torch.zeros(h.shape[0], device=cuda),
                              torch.zeros(h.shape[0], device=cuda))


@pytest.mark.cuda
def test_lm_gradient_on_the_card_matches_the_cpu(cuda):
    """Reduced gemma3-4b, bf16 compute: the gradient through the kernels
    against the CPU's plain path, and the kernels' launches per gradient
    (per layer one attention backward and two forwards, remat's recompute
    the second; one CE each)."""
    w0, g_cpu, _ = zoo.make_zoo_lm("gemma3-4b", device="cpu")
    w_gpu, g_gpu, _ = zoo.make_zoo_lm("gemma3-4b", w0=w0, device=cuda)
    kernels.reset_launch_counts()
    got = g_gpu(w_gpu, 0, 0).cpu()
    assert kernels.launch_counts() == _counts(
        flash_attention_fwd=2 * 6, flash_attention_bwd=6, fused_ce_fwd=1,
        fused_ce_bwd=1)
    want = g_cpu(w0, 0, 0)
    rel = float(torch.linalg.vector_norm(got - want)
                / torch.linalg.vector_norm(want))
    assert rel <= 2e-2


_DTYPE_MIX = [("float32",) * 5,
              ("float32", "bfloat16", "float32", "bfloat16", "float32"),
              ("bfloat16",) * 5]


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", _DTYPE_MIX)
@pytest.mark.parametrize("p,n", [(1, 1188), (2, 131072 + 777), (4, 4099)])
def test_elastic_update_kernel_equals_plain_version(cuda, dtypes, p, n):
    """fused_elastic_update against its plain version on the card and on
    the CPU, bit for bit, over the storage dtypes (W, V, G, C, M)."""
    rng = np.random.RandomState(n + p)
    shapes = [(p, n)] * 3 + [(n,)] * 2
    if p == 1:
        shapes = [(n,)] * 5
    host = [torch.from_numpy(rng.randn(*s).astype(np.float32))
            .to(getattr(torch, dt)) for s, dt in zip(shapes, dtypes)]
    outs = []
    for dev, fn in ((cuda, eu.fused_elastic_update),
                    (cuda, eu.fused_elastic_update_ref),
                    ("cpu", eu.fused_elastic_update_ref)):
        xs = [t.clone().to(dev) for t in host]
        fn(*xs, eta=ETA, rho=RHO, mu=MU, n_workers=p)
        outs.append([xs[i].cpu() for i in (0, 1, 3)])
    torch.cuda.synchronize()
    for got in outs[1:]:
        for a, b in zip(outs[0], got):
            assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
def test_elastic_update_refuses_a_non_contiguous_row(cuda):
    w, v = (torch.zeros(2, 64, device=cuda) for _ in range(2))
    g = torch.zeros(2, 128, device=cuda)[:, ::2]
    c, m = torch.zeros(64, device=cuda), torch.zeros(64, device=cuda)
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="contiguous"):
        eu.fused_elastic_update(w, v, g, c, m, eta=ETA, rho=RHO, mu=MU,
                                n_workers=2)
    with pytest.raises(ValueError):
        eu.fused_elastic_update(w, v, g.contiguous(), c, m.cpu(), eta=ETA,
                                rho=RHO, mu=MU, n_workers=2)
    assert kernels.launch_counts()["fused_elastic_update"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("compression", ["none", "bf16"])
def test_multi_pod_step_on_the_card_matches_the_cpu(cuda, compression):
    """Reduced gemma3-4b, P = 4, ring, two microbatches, τ = 2: the card's
    state after 4 steps against the CPU's from the same state (loss 1e-3
    relative, params by relative norm 2e-2, the limits of the LM's
    gradient), the same bits with overlap on and off, and one
    fused_elastic_update per exchange step (each layer's attention
    forward twice per gradient: remat's recompute)."""
    cfg = configs.get("gemma3-4b").reduced
    rng = np.random.RandomState(0)
    batches = [{"tokens": rng.randint(0, 512, (4, 2, 24)),
                "targets": rng.randint(0, 512, (4, 2, 24)),
                "mask": np.ones((4, 2, 24), np.float32)} for _ in range(4)]
    runs = {}
    for dev, overlap in (("cpu", True), (cuda, True), (cuda, False)):
        ecfg = elastic.ElasticConfig(
            easgd=EASGDConfig(eta=0.05, rho=0.05, mu=MU, tau=2),
            schedule="ring", compression=compression, overlap=overlap)
        build = build_train_step(cfg, ecfg, n_pods=4, per_pod_batch=2,
                                 seq=24, microbatches=2, device=dev)
        if dev == "cpu":
            init = build.init_state()
        state = init.to(dev)
        kernels.reset_launch_counts()
        losses = []
        for b in batches:
            state, metrics = build.step(state, b)
            losses.append(float(metrics["loss"]))
        counts = kernels.launch_counts()
        if dev != "cpu":
            assert counts == _counts(fused_elastic_update=2,
                                     flash_attention_fwd=2 * 6 * 4 * 2 * 4,
                                     flash_attention_bwd=6 * 4 * 2 * 4,
                                     fused_ce_fwd=4 * 2 * 4,
                                     fused_ce_bwd=4 * 2 * 4)
        runs[(str(dev), overlap)] = (state.to("cpu"), losses)
    cpu, cpu_losses = runs[("cpu", True)]
    on, off = runs[(str(cuda), True)], runs[(str(cuda), False)]
    for name in ("params", "momentum", "center", "ef_error"):
        a, b = getattr(on[0], name), getattr(off[0], name)
        assert (a is None and b is None) or torch.equal(a, b)
    for got, want in zip(on[1], cpu_losses):
        assert abs(got - want) <= 1e-3 * abs(want)
    rel = float(torch.linalg.vector_norm(on[0].params - cpu.params)
                / torch.linalg.vector_norm(cpu.params))
    assert rel <= 2e-2


def _ssd_inputs(B, H, S, P, N, scale, seed, device):
    rng = np.random.RandomState(seed)
    a = -scale * np.log1p(np.exp(rng.randn(B * H, S)))
    x, dy = (rng.randn(B * H, S, P) for _ in range(2))
    b, c = (rng.randn(B, S, N) for _ in range(2))
    return [torch.from_numpy(t.astype(np.float32)).to(device)
            for t in (a, x, b, c, dy)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,S,P,N,L,scale", [
    (1, 3, 512, 64, 128, 256, 1.0),     # full-width chunk, 3 of 48 heads
    (2, 8, 32, 16, 16, 16, 1.0),        # reduced mamba2 (S 24 padded)
    (1, 2, 192, 24, 40, 96, 1.0),       # ragged tiles on every side
    (2, 2, 256, 16, 16, 128, 2.0),      # cumsum far below -88
    (1, 5, 512, 64, 128, 256, 1.0),     # 5 heads: groups of 2, 2 and 1
    (1, 48, 512, 64, 128, 256, 1.0),    # full width, all 48 heads
])
def test_ssd_kernels_match_plain_versions(cuda, B, H, S, P, N, L, scale):
    a, x, b, c, dy = _ssd_inputs(B, H, S, P, N, scale, S + P, cuda)
    kernels.reset_launch_counts()
    y = ssd_chunk.ssd_intra_fwd(a, x, b, c, L)
    grads = ssd_chunk.ssd_intra_bwd(a, x, b, c, dy, L)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == _counts(ssd_intra_fwd=1,
                                              ssd_intra_bwd=1)
    _close(y, ssd_chunk.ssd_intra_fwd_ref(a, x, b, c, L), "fwd")
    for got, want in zip(grads, ssd_chunk.ssd_intra_bwd_ref(a, x, b, c, dy,
                                                            L)):
        assert got.shape == want.shape and bool(torch.isfinite(got).all())
        _close(got, want, "bwd")
    # deterministic: no atomics, fixed order of every sum
    again = ssd_chunk.ssd_intra_bwd(a, x, b, c, dy, L)
    assert all(torch.equal(p, q) for p, q in zip(grads, again))


@pytest.mark.cuda
def test_ssd_kernels_refuse_what_they_do_not_take(cuda):
    a, x, b, c, dy = _ssd_inputs(1, 2, 32, 16, 16, 1.0, 0, cuda)
    kernels.reset_launch_counts()
    with pytest.raises(TypeError, match="float32"):
        ssd_chunk.ssd_intra_fwd(a, x.double(), b, c, 16)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_chunk.ssd_intra_bwd(a, x, b, c, dy.transpose(1, 2)
                                .contiguous().transpose(1, 2), 16)
    assert kernels.launch_counts()["ssd_intra_fwd"] == 0
    assert kernels.launch_counts()["ssd_intra_bwd"] == 0


@pytest.mark.cuda
def test_ssd_kernels_refuse_long_chunks_and_wide_heads(cuda):
    """The kernels hold a chunk's G band on chip: L up to 256, P up to
    64."""
    a, x, b, c, dy = _ssd_inputs(1, 2, 512, 16, 16, 1.0, 0, cuda)
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="chunks up to 256"):
        ssd_chunk.ssd_intra_fwd(a, x, b, c, 512)
    wide = torch.zeros((2, 512, 128), device=cuda)
    with pytest.raises(ValueError, match="head dims up to 64"):
        ssd_chunk.ssd_intra_bwd(a, wide, b, c, wide, 256)
    assert kernels.launch_counts()["ssd_intra_fwd"] == 0
    assert kernels.launch_counts()["ssd_intra_bwd"] == 0


@pytest.mark.cuda
def test_mamba2_gradient_on_the_card_matches_the_cpu(cuda):
    """Reduced mamba2-780m, bf16 compute: the gradient through the kernels
    against the CPU's plain path, and per layer one SSD backward and two
    forwards (remat's recompute the second), one CE each, per
    gradient."""
    w0, g_cpu, _ = zoo.make_zoo_lm("mamba2-780m", device="cpu")
    w_gpu, g_gpu, _ = zoo.make_zoo_lm("mamba2-780m", w0=w0, device=cuda)
    kernels.reset_launch_counts()
    got = g_gpu(w_gpu, 0, 0).cpu()
    assert kernels.launch_counts() == _counts(
        ssd_intra_fwd=2 * 4, ssd_intra_bwd=4, fused_ce_fwd=1,
        fused_ce_bwd=1)
    want = g_cpu(w0, 0, 0)
    rel = float(torch.linalg.vector_norm(got - want)
                / torch.linalg.vector_norm(want))
    assert rel <= 2e-2

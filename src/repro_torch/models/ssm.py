"""Mamba-2 (SSD, state-space duality, arXiv:2405.21060) (the port of
``repro/models/ssm.py``: ``_dims``, ``ssm_defs``, ``_split_in`` (one
``split`` of the input projection in ``ssm_block``),
``_causal_conv``, ``_ssd_chunked``, ``ssd_step`` and ``ssm_block``).

The SSD layer computes, per head h with scalar decay ``a_t = exp(Δt·A_h)``::

    S_t = a_t · S_{t-1} + Δt·B_t ⊗ x_t          (state: head_dim × d_state)
    y_t = C_t · S_t + D_h · x_t

in the chunked form: within a chunk, the quadratic attention-like term
goes through ``kernels.ssd_chunk.SSDIntraChunk`` (the CUDA kernels on the
card, the plain versions on the CPU); across chunks, the states pass in
plain torch, vectorised over chunks, with only the short recurrence of the
``(B, H, P, N)`` states looped over the chunks (the reference's
``lax.scan``).

The kernels take ``(B·H, S, ·)`` rows, so ``_ssd_chunked`` makes
contiguous copies of ``a`` and ``Δt·x`` in that layout (and of the output
back), while B and C stay ``(B, S, N)``, shared by the heads. Without
autograd (serving's prefill) it calls the forward kernel's wrapper
directly, so nothing is saved for a backward.

Serving (``ssm_block`` with a cache ``{conv: (B, K−1, conv_dim), state:
(B, H, P, N) f32}``): the prefill is the chunked form, keeping the last
K−1 conv inputs and the final state; decode slides the conv history by
one and takes the O(1) recurrence ``ssd_step``. Both write the cache in
place and return it. ``sctx.shard`` stands at the reference's points (a no-op
without a mesh).

On a mesh whose ``model`` axis splits the heads (``models.tp``) the block
is a model-parallel region over them. The params keep the reference's
specs, which split ``w_in``'s ``[z | x | B | C | dt]`` columns and the
conv's ``[x | B | C]`` channels in contiguous blocks that are not the
columns of any rank's heads, so the block reads those leaves whole
(``tp.all_gather`` over ``model``, whose backward sums the ranks' partial
gradients) and takes its heads' ``z``, ``x`` and ``dt`` columns with the
whole of ``B`` and ``C``. ``A_log``, ``D`` and ``dt_bias`` are
replicated and enter through ``copy_in``; the SSD kernels run on the
rank's heads; the gated norm's variance over the split ``d_inner`` is a
``tp.model_sum`` (forward and backward the all-reduce); ``norm`` and
``w_out`` split as the heads do, and ``w_out``'s contraction leaves
through ``reduce_out``. Where ``model`` does not split the heads every
rank runs the block whole, reading each model-split leaf through
``tp.gather_whole``. Serving on a mesh, the state cache holds the rank's
heads; the conv cache's ``conv_dim`` columns split over ``model`` in
blocks that are not the rank's heads' either, so the decode reads the
history gathered and each step writes its block of the new inputs, the
x columns gathered over ``model`` (``_conv_read`` / ``_conv_write``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ssd_chunk
from repro_torch.kernels.ssd_chunk import SSDIntraChunk, chunk_len
from repro_torch.models import sctx, tp
from repro_torch.models.common import ModelConfig, ParamDef, rms_norm


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.d_state
    return d_inner, n_heads, conv_dim


def ssm_defs(cfg: ModelConfig) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    d_inner, n_heads, conv_dim = _dims(cfg)
    # in_proj emits [z (d_inner) | x (d_inner) | B (N) | C (N) | dt (H)]
    return {
        "w_in": ParamDef((d, 2 * d_inner + 2 * s.d_state + n_heads),
                         ("embed", "inner")),
        "conv_w": ParamDef((s.d_conv, conv_dim), ("conv", "inner")),
        "conv_b": ParamDef((conv_dim,), ("inner",), init="zeros"),
        "A_log": ParamDef((n_heads,), ("state",), init="zeros"),
        "D": ParamDef((n_heads,), ("state",), init="ones"),
        "dt_bias": ParamDef((n_heads,), ("state",), init="zeros"),
        "norm": ParamDef((d_inner,), ("inner",), init="zeros"),
        "w_out": ParamDef((d_inner, d), ("inner", "embed_out")),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv over time. x: (B, S, C); w: (K, C); b: (C,).
    The reference's Python ``sum`` of the K shifted products, each product
    and each partial sum rounded to x's dtype."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = 0
    for i in range(K):
        out = out + xp[:, i:i + S] * w[i][None, None]
    return out + b[None, None]


def _ssd_chunked(xh, dt, A, Bm, Cm, chunk: int, state0=None):
    """Chunked SSD scan. xh: (B, S, H, P) inputs (Δt is applied here); dt:
    (B, S, H) softplus'ed step sizes; A: (H,) negative decay rates; Bm, Cm:
    (B, S, N) input / output projections (one group). Returns y
    (B, S, H, P) f32 and the final state (B, H, P, N)."""
    Bsz, S, H, P = xh.shape
    N = Bm.shape[-1]
    L = min(chunk, S)
    pad = (-S) % L
    if pad:
        # dt = 0 padding: decay 1 and zero input, so the state is unaffected
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
        S = S + pad
    chunk_len(S, L)
    nc = S // L

    a = (dt * A[None, None, :]).float()                 # (B,S,H) ≤ 0
    xbar = (xh * dt[..., None]).float()                 # Δt·x
    Bf, Cf = Bm.float().contiguous(), Cm.float().contiguous()

    # intra-chunk: the kernel, on (B·H, S, ·) rows
    a_bh = a.permute(0, 2, 1).reshape(Bsz * H, S).contiguous()
    x_bh = xbar.permute(0, 2, 1, 3).reshape(Bsz * H, S, P).contiguous()
    if torch.is_grad_enabled():
        y_intra = SSDIntraChunk.apply(a_bh, x_bh, Bf, Cf, L)
    else:
        y_intra = ssd_chunk.ssd_intra_fwd(a_bh, x_bh, Bf, Cf, L)
    y_intra = y_intra.reshape(Bsz, H, nc, L, P).permute(0, 2, 3, 1, 4)

    # inter-chunk, vectorised over chunks: cum (B,nc,L,H) from chunk start
    cum = torch.cumsum(a.reshape(Bsz, nc, L, H), dim=2)
    total = cum[:, :, -1]                               # (B,nc,H)
    x_c = xbar.reshape(Bsz, nc, L, H, P)
    B_c, C_c = Bf.reshape(Bsz, nc, L, N), Cf.reshape(Bsz, nc, L, N)
    # each chunk's own input to the state it passes on:
    # Σ_j exp(total − cum_j) B_j x_jᵀ
    decay_in = torch.exp(total[:, :, None, :] - cum)    # (B,nc,L,H)
    s_in = torch.einsum("bcln,bclhp->bchpn", B_c,
                        x_c * decay_in[..., None])
    state = (torch.zeros((Bsz, H, P, N), dtype=torch.float32,
                         device=xh.device) if state0 is None else state0)
    starts = []
    for k in range(nc):
        starts.append(state)
        state = state * torch.exp(total[:, k])[:, :, None, None] + s_in[:, k]
    prev = torch.stack(starts, dim=1)                   # (B,nc,H,P,N)
    # y_prev[i] = exp(cum_i) · C_i · S_prev
    y_prev = torch.einsum("bcln,bchpn->bclhp", C_c, prev)
    y = y_prev * torch.exp(cum)[..., None] + y_intra
    y = y.reshape(Bsz, S, H, P)
    if pad:
        y = y[:, :S - pad]
    return y, state


def ssd_step(state, x_t, dt_t, A, B_t, C_t):
    """The O(1) decode recurrence. state: (B, H, P, N) f32; x_t: (B, H, P);
    dt_t: (B, H); B_t, C_t: (B, N). Returns ``(state, y)``, y (B, H, P)
    f32."""
    a = torch.exp(dt_t * A[None, :])[..., None, None]          # (B,H,1,1)
    upd = torch.einsum("bn,bhp->bhpn", B_t.float(),
                       (x_t * dt_t[..., None]).float())
    state = state * a + upd
    y = torch.einsum("bn,bhpn->bhp", C_t.float(), state)
    return state, y


def _mesh_params(cfg: ModelConfig, p, lay):
    """The leaves this rank's part of the block reads, and its heads'
    share of ``d_inner`` and of the heads: the whole block's leaves when
    ``model`` does not split the heads (gathered, each rank computing the
    whole block), else the rank's heads' columns (module docstring)."""
    s = cfg.ssm
    d_inner, n_heads, conv_dim = _dims(cfg)
    n_in = 2 * d_inner + 2 * s.d_state + n_heads
    full = {"w_in": (1, n_in), "conv_w": (1, conv_dim),
            "conv_b": (0, conv_dim), "norm": (0, d_inner),
            "w_out": (0, d_inner)}
    g = lay.model_group
    if not lay.ssm_heads:
        return {k: t if k not in full or t.shape[full[k][0]] == full[k][1]
                else tp.gather_whole(t, full[k][0], g)
                for k, t in p.items()}, d_inner, n_heads
    m, r = lay.model_size, lay.model_rank
    dl, hl = d_inner // m, n_heads // m

    def whole(k):
        t = p[k]
        dim, n = full[k]
        return tp.copy_in(t) if t.shape[dim] == n \
            else tp.all_gather(t, dim, g)

    def mine(t, dim, n, block):
        # the rank's block of a leaf that model splits as the heads (or
        # leaves whole)
        if t.shape[dim] != n:
            return t
        return tp.copy_in(t).narrow(dim, r * block, block)

    w_in, conv_w, conv_b = whole("w_in"), whole("conv_w"), whole("conv_b")
    N = s.d_state
    z, xw, bc, dt = torch.split(w_in, [d_inner, d_inner, 2 * N, n_heads], 1)
    cx, cbc = torch.split(conv_w, [d_inner, 2 * N], 1)
    bx, bbc = torch.split(conv_b, [d_inner, 2 * N], 0)
    out = {
        "w_in": torch.cat([z.narrow(1, r * dl, dl), xw.narrow(1, r * dl, dl),
                           bc, dt.narrow(1, r * hl, hl)], 1),
        "conv_w": torch.cat([cx.narrow(1, r * dl, dl), cbc], 1),
        "conv_b": torch.cat([bx.narrow(0, r * dl, dl), bbc], 0),
        "norm": mine(p["norm"], 0, d_inner, dl),
        "w_out": mine(p["w_out"], 0, d_inner, dl)}
    for k in ("A_log", "D", "dt_bias"):
        out[k] = mine(p[k], 0, n_heads, hl)
    return out, dl, hl


def _conv_read(cfg: ModelConfig, conv, lay, heads: bool):
    """The conv history that this rank's block reads, from its block of the
    conv cache: the cache's ``conv_dim`` columns gathered over ``model``
    where the cache splits them (its blocks are not the rank's heads'
    columns), then the rank's heads' x columns with the whole of B and C
    where ``model`` splits the heads. Unchanged without a mesh."""
    if lay is None or lay.model_group is None:
        return conv
    d_inner, _, conv_dim = _dims(cfg)
    if conv.shape[-1] != conv_dim:
        conv = tp.gather_dim(conv, 2, lay.model_group)
    if not heads:
        return conv
    dl = d_inner // lay.model_size
    return torch.cat([conv[..., lay.model_rank * dl:
                           (lay.model_rank + 1) * dl],
                      conv[..., d_inner:]], dim=-1)


def _conv_write(cfg: ModelConfig, conv, rows, lay, heads: bool):
    """Write the conv inputs ``rows`` (B, K−1, ·), in the rank's columns,
    into its block of the conv cache, in place: the x columns gathered
    over ``model`` where it splits the heads, then the cache block's
    columns of the whole ``conv_dim``."""
    if lay is None or lay.model_group is None:
        conv.copy_(rows)
        return
    d_inner, _, conv_dim = _dims(cfg)
    if heads:
        dl = d_inner // lay.model_size
        rows = torch.cat([tp.gather_dim(rows[..., :dl].contiguous(), 2,
                                        lay.model_group),
                          rows[..., dl:]], dim=-1)
    n = conv.shape[-1]
    conv.copy_(rows if n == conv_dim
               else rows[..., lay.model_rank * n:(lay.model_rank + 1) * n])


def _gated_norm(y, gamma, d_inner: int, eps=1e-6):
    """``rms_norm`` over a ``d_inner`` that ``model`` splits: the sum of
    squares of the rank's channels summed over ``model`` both ways."""
    y32 = y.to(torch.float32)
    var = tp.model_sum(torch.sum(torch.square(y32), dim=-1,
                                 keepdim=True)) / d_inner
    out = y32 * torch.rsqrt(var + eps) * (1.0 + gamma.to(torch.float32))
    return out.to(y.dtype)


def ssm_block(cfg: ModelConfig, p, x, positions=None, *, cache=None,
              cache_pos=None, **_unused):
    """Mamba-2 block -> ``(y, cache)``: the training / prefill chunked form,
    or with a cache and S 1 the decode step."""
    s = cfg.ssm
    cd = cfg.compute_dtype
    d_inner, n_heads, _ = _dims(cfg)
    B_, S, _ = x.shape
    lay = tp.current()
    heads, dl = False, d_inner       # heads: a region over the rank's heads
    if lay is not None and lay.model_group is not None:
        p, dl, n_heads = _mesh_params(cfg, p, lay)
        heads = lay.ssm_heads
        if heads:
            x = tp.copy_in(x)

    # one split (its backward one concatenation, where five slices would
    # each write a zero-filled gradient of h)
    h = torch.einsum("bsd,de->bse", x, p["w_in"].to(cd))
    z, xi, Bm, Cm, dt = torch.split(h, [dl, dl, s.d_state, s.d_state,
                                        n_heads], dim=-1)
    z = sctx.shard(z, "batch", "seq", "inner")
    xbc = sctx.shard(torch.cat([xi, Bm, Cm], dim=-1),
                     "batch", "seq", "inner")
    A = -torch.exp(p["A_log"].float())
    if cache is not None and S == 1:
        # decode: the sliding conv history, then the recurrent SSD step
        conv_hist = torch.cat([_conv_read(cfg, cache["conv"], lay, heads),
                               xbc], dim=1)                    # (B, K, ·)
        conv_out = torch.einsum("bkc,kc->bc", conv_hist.to(cd),
                                p["conv_w"].to(cd)) + p["conv_b"].to(cd)
        xi, Bm, Cm = torch.split(F.silu(conv_out),
                                 [dl, s.d_state, s.d_state], dim=-1)
        dt_t = F.softplus(dt[:, 0] + p["dt_bias"].float())
        xh = xi.reshape(B_, n_heads, s.head_dim)
        state, y = ssd_step(cache["state"], xh, dt_t, A, Bm, Cm)
        y = y + p["D"].float()[None, :, None] * xh
        y = y.reshape(B_, 1, dl)
        _conv_write(cfg, cache["conv"], conv_hist[:, 1:], lay, heads)
        cache["state"].copy_(state)
    else:
        conv_out = F.silu(_causal_conv(xbc.to(cd), p["conv_w"].to(cd),
                                       p["conv_b"].to(cd)))
        xi, Bm, Cm = torch.split(conv_out, [dl, s.d_state, s.d_state],
                                 dim=-1)
        dt_sp = F.softplus(dt.float() + p["dt_bias"].float())
        xh = sctx.shard(xi.reshape(B_, S, n_heads, s.head_dim),
                        "batch", "seq", "heads", "head_dim")
        y, state = _ssd_chunked(xh.float(), dt_sp, A, Bm, Cm, s.chunk)
        y = y + p["D"].float()[None, None, :, None] * xh
        y = y.reshape(B_, S, dl)
        if cache is not None:
            _conv_write(cfg, cache["conv"], xbc[:, -(s.d_conv - 1):], lay,
                        heads)
            cache["state"].copy_(state)
    if cache is not None:
        cache = {"conv": cache["conv"], "state": cache["state"]}

    # gated RMSNorm (Mamba-2) + out proj
    y = sctx.shard(y.to(cd), "batch", "seq", "inner") * F.silu(z)
    if heads:
        y = _gated_norm(y, p["norm"], d_inner)
    else:
        y = rms_norm(y, p["norm"])
    y = torch.einsum("bse,ed->bsd", y, p["w_out"].to(cd))
    if heads:
        y = tp.reduce_out(y)
    return y, cache

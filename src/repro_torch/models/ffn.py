"""Dense gated FFN, SwiGLU / GeGLU (the port of ``repro/models/ffn.py``).
f32 weights are cast to the compute dtype at each product. On a mesh whose
``model`` axis splits ``ff`` the block is a model-parallel region
(``models.tp``): ``copy_in`` on the input, ``reduce_out`` on the down
projection's partial sum."""
from __future__ import annotations

import torch

from repro_torch.models import sctx, tp
from repro_torch.models.common import ModelConfig, ParamDef, act_fn


def ffn_defs(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "w_gate": ParamDef((d, f), ("embed", "ff")),
        "w_up": ParamDef((d, f), ("embed", "ff")),
        "w_down": ParamDef((f, d), ("ff", "embed_out")),
    }


def ffn_block(cfg: ModelConfig, p, x):
    cd = cfg.compute_dtype
    act = act_fn(cfg.act)
    region = tp.current() is not None and tp.current().ff
    if region:
        x = tp.copy_in(x)
    g = act(sctx.shard(torch.matmul(x, p["w_gate"].to(cd)),
                       "batch", "seq", "ff"))
    u = sctx.shard(torch.matmul(x, p["w_up"].to(cd)), "batch", "seq", "ff")
    y = torch.matmul(g * u, p["w_down"].to(cd))
    if region:
        y = tp.reduce_out(y)
    return sctx.shard(y, "batch", "seq", "embed")

"""Dense gated FFN, SwiGLU / GeGLU (the port of ``repro/models/ffn.py``).
f32 weights are cast to the compute dtype at each product."""
from __future__ import annotations

import torch

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
    g = act(torch.matmul(x, p["w_gate"].to(cd)))
    u = torch.matmul(x, p["w_up"].to(cd))
    return torch.matmul(g * u, p["w_down"].to(cd))

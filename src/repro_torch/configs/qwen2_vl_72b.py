"""qwen2-vl-72b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064, M-RoPE, dynamic resolution. [arXiv:2409.12191; hf]

Backbone only — the vision tower is a STUB: input_specs() provides
precomputed patch embeddings merged into the leading positions.

The port of ``repro/configs/qwen2_vl_72b.py``, field for field, with torch
dtypes.
"""
import torch

from repro_torch.configs.base import QUADRATIC_SHAPES, ArchSpec
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    qkv_bias=True,
    act="silu",
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),        # t/h/w rotary split (sums to 64)
    patch_embed_tokens=256,             # vision stub: 256 leading positions
    fsdp=True,
)

REDUCED = ModelConfig(
    name="qwen2-vl-reduced",
    family="vlm",
    n_layers=4,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    qkv_bias=True,
    act="silu",
    mrope_sections=(2, 3, 3),
    patch_embed_tokens=8,
    loss_chunk=64,
)

SPEC = ArchSpec(
    arch_id="qwen2-vl-72b",
    config=FULL,
    reduced=REDUCED,
    shapes=QUADRATIC_SHAPES,   # long_500k SKIPPED: pure full attention
    notes="M-RoPE with (16,24,24) sections; vision frontend stubbed via "
          "precomputed patch embeddings; FSDP (72B).",
    momentum_dtype=torch.float32,
    center_dtype=torch.bfloat16,
    train_microbatches=16,
)

"""phi3-mini-3.8b [dense]: 32L d_model=3072 32H (kv=32) d_ff=8192
vocab=32064, RoPE SwiGLU. [arXiv:2404.14219; unverified]

The port of ``repro/configs/phi3_mini.py``, field for field, with torch
dtypes.
"""
from repro_torch.configs.base import QUADRATIC_SHAPES, ArchSpec
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    act="silu",
    rope_theta=10_000.0,
    fsdp=True,
)

REDUCED = ModelConfig(
    name="phi3-mini-reduced",
    family="dense",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    act="silu",
    loss_chunk=64,
)

SPEC = ArchSpec(
    arch_id="phi3-mini-3.8b",
    config=FULL,
    reduced=REDUCED,
    shapes=QUADRATIC_SHAPES,   # long_500k SKIPPED: pure full attention
    notes="MHA 32 heads (divides model axis); small 32k vocab.",
)

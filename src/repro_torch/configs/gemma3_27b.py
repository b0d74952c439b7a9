"""gemma3-27b [dense]: 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144, 5:1 local:global, 128k. [hf:google/gemma-3 family; unverified]

The port of ``repro/configs/gemma3_27b.py``, field for field, with torch
dtypes.
"""
import torch

from repro_torch.configs.base import ALL_SHAPES, ArchSpec
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    pattern=("local",) * 5 + ("attn",),
    window=1024,
    rope_theta=10_000.0,
    rope_theta_global=1_000_000.0,
    qk_norm=True,
    act="gelu",
    tie_embeddings=True,
    fsdp=True,
)

REDUCED = ModelConfig(
    name="gemma3-27b-reduced",
    family="dense",
    n_layers=8,           # 1 period + 2 remainder
    d_model=96,
    n_heads=4,
    n_kv_heads=2,
    head_dim=24,
    d_ff=192,
    vocab_size=512,
    pattern=("local",) * 5 + ("attn",),
    window=8,
    rope_theta=10_000.0,
    rope_theta_global=1_000_000.0,
    qk_norm=True,
    act="gelu",
    tie_embeddings=True,
    fsdp=False,
    loss_chunk=64,
)

SPEC = ArchSpec(
    arch_id="gemma3-27b",
    config=FULL,
    reduced=REDUCED,
    shapes=ALL_SHAPES,
    notes="As gemma3-4b but FSDP over `data` (27B params); 62 = 10 periods "
          "of (5 local + 1 global) + 2 remainder local layers.",
    momentum_dtype=torch.float32,
    center_dtype=torch.bfloat16,
    train_microbatches=16,
)

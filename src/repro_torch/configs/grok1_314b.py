"""grok-1-314b [moe]: 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8 experts top-2. [hf:xai-org/grok-1; unverified]

The port of ``repro/configs/grok1_314b.py``, field for field, with torch
dtypes.
"""
import torch

from repro_torch.configs.base import QUADRATIC_SHAPES, ArchSpec
from repro_torch.models.common import ModelConfig, MoEConfig

FULL = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    moe=MoEConfig(n_experts=8, top_k=2, n_shared=0, d_expert=32768,
                  capacity_factor=1.25),
    act="gelu",
    fsdp=True,
    param_dtype=torch.bfloat16,  # 314B: bf16 params + bf16 opt state to fit
)

REDUCED = ModelConfig(
    name="grok1-reduced",
    family="moe",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    moe=MoEConfig(n_experts=4, top_k=2, n_shared=0, d_expert=128,
                  capacity_factor=1.25, dispatch_groups=4),
    act="gelu",
    loss_chunk=64,
)

SPEC = ArchSpec(
    arch_id="grok-1-314b",
    config=FULL,
    reduced=REDUCED,
    shapes=QUADRATIC_SHAPES,   # long_500k SKIPPED: pure full attention
    notes="8 experts do not divide model axis 16 -> experts replicated, "
          "expert d_ff (32768) tensor-parallel over `model`; FSDP over "
          "`data`; bf16 params + bf16 optimizer state to fit 16 GB/chip.",
    momentum_dtype=torch.bfloat16,
    center_dtype=torch.bfloat16,
    train_microbatches=16,
)

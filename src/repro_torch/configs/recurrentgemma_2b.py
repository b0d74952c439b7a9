"""recurrentgemma-2b [hybrid]: 26L d_model=2560 10H (MQA kv=1) d_ff=7680
vocab=256000, RG-LRU : local attention = 2 : 1. [arXiv:2402.19427; hf]

The port of ``repro/configs/recurrentgemma_2b.py``, field for field, with torch
dtypes.
"""
from repro_torch.configs.base import ALL_SHAPES, ArchSpec
from repro_torch.models.common import ModelConfig, RGLRUConfig

FULL = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    pattern=("rglru", "rglru", "local"),
    window=2048,
    rglru=RGLRUConfig(width=2560, d_conv=4, c=8.0),
    act="gelu",
    tie_embeddings=True,
    fsdp=True,
)

REDUCED = ModelConfig(
    name="recurrentgemma-reduced",
    family="hybrid",
    n_layers=5,               # 1 period + 2 remainder rglru
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    pattern=("rglru", "rglru", "local"),
    window=8,
    rglru=RGLRUConfig(width=64, d_conv=4, c=8.0),
    act="gelu",
    tie_embeddings=True,
    loss_chunk=64,
)

SPEC = ArchSpec(
    arch_id="recurrentgemma-2b",
    config=FULL,
    reduced=REDUCED,
    shapes=ALL_SHAPES,        # long_500k RUNS: recurrence O(1), attn O(window)
    notes="Griffin block pattern (2 RG-LRU + 1 local-attn), window 2048, "
          "MQA kv=1 (replicated); 26 = 8 periods + 2 remainder RG-LRU.",
)

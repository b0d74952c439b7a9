"""musicgen-medium [audio]: 48L d_model=1536 24H d_ff=6144 vocab=2048,
decoder-only over EnCodec tokens. [arXiv:2306.05284; hf]

Backbone only — the EnCodec tokenizer/delay-pattern interleaver is a STUB:
inputs are already-flattened codebook token ids (vocab 2048).
Adaptation note (DESIGN.md): the original uses learned sinusoidal positions;
we use RoPE (TPU-idiomatic, numerically equivalent role).

The port of ``repro/configs/musicgen_medium.py``, field for field, with torch
dtypes.
"""
from repro_torch.configs.base import QUADRATIC_SHAPES, ArchSpec
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    act="gelu",
    fsdp=True,
)

REDUCED = ModelConfig(
    name="musicgen-reduced",
    family="audio",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    act="gelu",
    loss_chunk=64,
)

SPEC = ArchSpec(
    arch_id="musicgen-medium",
    config=FULL,
    reduced=REDUCED,
    shapes=QUADRATIC_SHAPES,   # long_500k SKIPPED: pure full attention
    notes="24 heads do not divide model axis 16 -> attention replicated "
          "over `model`; tiny 2048 vocab (EnCodec codes).",
)

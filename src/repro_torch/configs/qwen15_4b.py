"""qwen1.5-4b [dense]: 40L d_model=2560 20H (GQA kv=20) d_ff=6912
vocab=151936, QKV bias. [hf:Qwen/Qwen1.5-0.5B family; hf]

The port of ``repro/configs/qwen15_4b.py``, field for field, with torch
dtypes.
"""
from repro_torch.configs.base import QUADRATIC_SHAPES, ArchSpec
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    head_dim=128,
    d_ff=6912,
    vocab_size=151936,
    qkv_bias=True,
    act="silu",
    rope_theta=1_000_000.0,
    fsdp=True,
)

REDUCED = ModelConfig(
    name="qwen1.5-4b-reduced",
    family="dense",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    qkv_bias=True,
    act="silu",
    rope_theta=1_000_000.0,
    loss_chunk=64,
)

SPEC = ArchSpec(
    arch_id="qwen1.5-4b",
    config=FULL,
    reduced=REDUCED,
    shapes=QUADRATIC_SHAPES,   # long_500k SKIPPED: pure full attention
    notes="MHA (kv=20); QKV bias; 20 heads do not divide model axis 16 -> "
          "attention replicated over `model`, FFN/vocab tensor-parallel.",
)

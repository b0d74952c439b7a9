"""gemma3-4b [dense]: 34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144,
5:1 local:global sliding-window attention (the port of
``repro/configs/gemma3_4b.py``, with torch dtypes)."""
from repro_torch.configs.base import ALL_SHAPES, ArchSpec
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=10240,
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
    name="gemma3-4b-reduced",
    family="dense",
    n_layers=6,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    pattern=("local",) * 5 + ("attn",),
    window=8,
    rope_theta=10_000.0,
    rope_theta_global=1_000_000.0,
    qk_norm=True,
    act="gelu",
    tie_embeddings=True,
    loss_chunk=64,
)

SPEC = ArchSpec(
    arch_id="gemma3-4b",
    config=FULL,
    reduced=REDUCED,
    shapes=ALL_SHAPES,
    notes="5:1 local:global; window 1024; dual rope theta; qk-norm; tied "
          "embeddings; 262k vocab.",
)

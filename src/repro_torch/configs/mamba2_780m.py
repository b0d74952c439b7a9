"""mamba2-780m [ssm]: 48L d_model=1536 attention-free, ssm_state=128, SSD
(the port of ``repro/configs/mamba2_780m.py``, with torch dtypes)."""
from repro_torch.configs.base import ALL_SHAPES, ArchSpec
from repro_torch.models.common import ModelConfig, SSMConfig

FULL = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=1,                  # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    pattern=("ssm",),
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, d_conv=4, chunk=256),
    tie_embeddings=True,
    fsdp=True,
)

REDUCED = ModelConfig(
    name="mamba2-reduced",
    family="ssm",
    n_layers=4,
    d_model=64,
    n_heads=1,
    n_kv_heads=1,
    d_ff=0,
    vocab_size=512,
    pattern=("ssm",),
    ssm=SSMConfig(d_state=16, head_dim=16, expand=2, d_conv=4, chunk=16),
    tie_embeddings=True,
    loss_chunk=64,
)

SPEC = ArchSpec(
    arch_id="mamba2-780m",
    config=FULL,
    reduced=REDUCED,
    shapes=ALL_SHAPES,
    notes="SSD chunked scan (chunk 256); heads = d_inner / 64 = 48; decode "
          "state is O(1) in context length.",
)

"""deepseek-v2-236b [moe]: 60L d_model=5120 128H, MLA kv_lora=512,
d_ff(expert)=1536, vocab=102400, 2 shared + 160 routed top-6.
[arXiv:2405.04434; hf]

The port of ``repro/configs/deepseek_v2_236b.py``, field for field, with
torch dtypes.
"""
import torch

from repro_torch.configs.base import QUADRATIC_SHAPES, ArchSpec
from repro_torch.models.common import MLAConfig, ModelConfig, MoEConfig

FULL = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,              # MLA: per-head K/V expanded from kv_lora
    head_dim=128,
    d_ff=1536,
    vocab_size=102400,
    pattern=("mla",),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=160, top_k=6, n_shared=2, d_expert=1536,
                  capacity_factor=1.25),
    act="silu",
    fsdp=True,
    param_dtype=torch.bfloat16,
)

REDUCED = ModelConfig(
    name="deepseek-v2-reduced",
    family="moe",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=64,
    vocab_size=512,
    pattern=("mla",),
    mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                  qk_rope_head_dim=8, v_head_dim=16),
    moe=MoEConfig(n_experts=8, top_k=2, n_shared=2, d_expert=64,
                  capacity_factor=1.25, dispatch_groups=4),
    act="silu",
    loss_chunk=64,
)

SPEC = ArchSpec(
    arch_id="deepseek-v2-236b",
    config=FULL,
    reduced=REDUCED,
    shapes=QUADRATIC_SHAPES,   # long_500k SKIPPED: full attention (MLA)
    notes="MLA: decode caches only (c_kv 512 + rope 64) per token and uses "
          "the absorbed-weight form. 160 experts / 16 model shards = 10 "
          "experts per shard (expert parallel); 2 shared experts dense.",
    momentum_dtype=torch.bfloat16,
    center_dtype=torch.bfloat16,
    train_microbatches=16,
)

"""grok-1-314b — 8-expert top-2 MoE [hf:xai-org/grok-1; unverified].

64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072, MoE 8e top-2.
bf16 params (the reference's 314B posture), so the norm gains are bf16
too.  ~314 B parameters: ~628 GB in bf16, on no single card; the card
runs it at full width with its depth cut (chip_smoke.py).
"""

from repro_torch.configs.registry import LM_SHAPES, ArchSpec
from repro_torch.models.moe import MoEConfig

CONFIG = MoEConfig(
    name="grok-1-314b",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab=131072,
    n_experts=8,
    top_k=2,
    param_dtype="bfloat16",
    attn_kv_chunk=2048,
)

SMOKE = MoEConfig(
    name="grok-1-smoke",
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv_heads=4,
    d_ff=256,
    vocab=512,
    n_experts=4,
    top_k=2,
    remat=False,
)


def spec() -> ArchSpec:
    return ArchSpec(
        name="grok-1-314b",
        family="lm-moe",
        model_cfg=CONFIG,
        smoke_cfg=SMOKE,
        shapes=LM_SHAPES,
        skip={"long_500k": "pure full-attention arch; see DESIGN.md §4"},
    )

"""qwen2-moe-a2.7b — 4 shared + 60 routed top-4 [hf:Qwen/Qwen1.5-MoE-A2.7B].

24L d_model=2048 16H (kv=16) d_ff=1408 (per expert) vocab=151936.
Shared experts fused into one SwiGLU of width 4*1408=5632 (public config's
shared_expert_intermediate_size).  ``CONFIG_EP`` pads 60 -> 64 experts (the
reference's expert-parallel knob); the pad experts are never routed to.
"""

from repro_torch.configs.registry import LM_SHAPES, ArchSpec
from repro_torch.models.moe import MoEConfig

CONFIG = MoEConfig(
    name="qwen2-moe-a2.7b",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=151936,
    n_experts=60,
    top_k=4,
    n_shared_experts=4,
    d_ff_shared=5632,
)

CONFIG_EP = MoEConfig(
    name="qwen2-moe-a2.7b-ep",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=151936,
    n_experts=60,
    top_k=4,
    n_shared_experts=4,
    d_ff_shared=5632,
    pad_experts_to=64,
)

SMOKE = MoEConfig(
    name="qwen2-moe-smoke",
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv_heads=8,
    d_ff=96,
    vocab=512,
    n_experts=6,
    top_k=4,
    n_shared_experts=2,
    d_ff_shared=192,
    remat=False,
)


def spec() -> ArchSpec:
    return ArchSpec(
        name="qwen2-moe-a2.7b",
        family="lm-moe",
        model_cfg=CONFIG,
        smoke_cfg=SMOKE,
        shapes=LM_SHAPES,
        skip={"long_500k": "pure full-attention arch; see DESIGN.md §4"},
    )

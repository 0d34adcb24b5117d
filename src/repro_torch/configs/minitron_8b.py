"""minitron-8b — pruned Nemotron [arXiv:2407.14679; hf].

32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000.
"""

from repro_torch.configs.registry import LM_SHAPES, ArchSpec
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="minitron-8b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=16384,
    vocab=256000,
)

SMOKE = TransformerConfig(
    name="minitron-8b-smoke",
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    d_ff=512,
    vocab=512,
    remat=False,
)


def spec() -> ArchSpec:
    return ArchSpec(
        name="minitron-8b",
        family="lm-dense",
        model_cfg=CONFIG,
        smoke_cfg=SMOKE,
        shapes=LM_SHAPES,
        skip={"long_500k": "pure full-attention arch; see DESIGN.md §4"},
    )

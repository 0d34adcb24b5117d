"""minitron-4b — pruned Nemotron [arXiv:2407.14679; hf].

32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000.  Pure full
attention -> long_500k skipped per assignment (DESIGN.md §4).
"""

from repro_torch.configs.registry import LM_SHAPES, ArchSpec
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="minitron-4b",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=9216,
    vocab=256000,
)

SMOKE = TransformerConfig(
    name="minitron-4b-smoke",
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv_heads=4,
    d_ff=384,
    vocab=512,
    remat=False,
)


def spec() -> ArchSpec:
    return ArchSpec(
        name="minitron-4b",
        family="lm-dense",
        model_cfg=CONFIG,
        smoke_cfg=SMOKE,
        shapes=LM_SHAPES,
        skip={"long_500k": "pure full-attention arch; sub-quadratic attention "
                           "required for 500k decode per assignment (bonus row "
                           "with local_window=4096 reported separately)"},
    )

"""qwen3-0.6b — qk_norm + GQA [hf:Qwen/Qwen3-8B family; hf].

28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936.  head_dim is
d_model // n_heads = 64 (the repo's rule; the published Qwen3 sets 128).
"""

from repro_torch.configs.registry import LM_SHAPES, ArchSpec
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="qwen3-0.6b",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=3072,
    vocab=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)

SMOKE = TransformerConfig(
    name="qwen3-0.6b-smoke",
    n_layers=2,
    d_model=96,
    n_heads=6,
    n_kv_heads=3,
    d_ff=256,
    vocab=512,
    qk_norm=True,
    tie_embeddings=True,
    remat=False,
)


def spec() -> ArchSpec:
    return ArchSpec(
        name="qwen3-0.6b",
        family="lm-dense",
        model_cfg=CONFIG,
        smoke_cfg=SMOKE,
        shapes=LM_SHAPES,
        skip={"long_500k": "pure full-attention arch"},
    )

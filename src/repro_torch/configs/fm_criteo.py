"""fm — pairwise FM via the O(nk) sum-square trick [ICDM'10 (Rendle); paper].

39 sparse fields, embed_dim=10, Criteo-shaped tables (8 ID tables of 10M
rows + 31 categorical tables of 10k rows -> 80.3M rows), held whole on one
card.
"""

from repro_torch.configs.registry import RECSYS_SHAPES, ArchSpec
from repro_torch.models.recsys import FMConfig, default_table_sizes

CONFIG = FMConfig(
    name="fm",
    n_fields=39,
    embed_dim=10,
    table_sizes=default_table_sizes(39, big=10_000_000, small=10_000),
)

SMOKE = FMConfig(
    name="fm-smoke",
    n_fields=8,
    embed_dim=10,
    table_sizes=default_table_sizes(8, big=1000, small=100),
)


def spec() -> ArchSpec:
    return ArchSpec(
        name="fm",
        family="recsys",
        model_cfg=CONFIG,
        smoke_cfg=SMOKE,
        shapes=RECSYS_SHAPES,
        skip={},
        notes="embedding lookup is the hot path; FM interaction kernel fused",
    )

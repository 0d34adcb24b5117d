"""gat-cora — [arXiv:1710.10903; paper].

2 layers, d_hidden=8, 8 heads, attention aggregator.  Per-edge attention
weights invalidate the paper's partial-aggregate sharing (DESIGN.md §4);
the window/bitset machinery is still used for neighborhood extraction.
"""

import dataclasses

from repro_torch.configs.registry import GNN_SHAPES, ArchSpec
from repro_torch.models.gnn import GNNConfig

TEMPLATE = GNNConfig(
    name="gat-cora",
    kind="gat",
    n_layers=2,
    d_in=-1,
    d_hidden=8,
    d_out=-1,
    n_heads=8,
    aggregator="attn",
)

SMOKE = GNNConfig(
    name="gat-smoke", kind="gat", n_layers=2, d_in=12, d_hidden=8, d_out=3,
    n_heads=4, aggregator="attn",
)


def cfg_for(dims) -> GNNConfig:
    return dataclasses.replace(TEMPLATE, d_in=dims["d_feat"], d_out=dims["classes"])


def spec() -> ArchSpec:
    return ArchSpec(
        name="gat-cora",
        family="gnn",
        model_cfg=TEMPLATE,
        smoke_cfg=SMOKE,
        shapes=GNN_SHAPES,
        skip={},
        notes="block sharing inapplicable (per-edge attention weights)",
    )

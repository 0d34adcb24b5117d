"""graphsage-reddit — [arXiv:1706.02216; paper].

2 layers, d_hidden=128, mean aggregator, sample sizes 25-10 (training uses
the shape table's 15-10 fanout for the sampled subgraph dims).
d_in / d_out are shape-dependent (each GNN shape carries its own d_feat /
classes), so the model config is a template instantiated per shape.

Paper-technique hook: the window-feature variant augments node inputs with
DBIndex-shared k-hop aggregates (models.gnn.khop_aggregate) — this is the
assigned arch where the paper's contribution lands most directly.
"""

import dataclasses

from repro_torch.configs.registry import GNN_SHAPES, ArchSpec
from repro_torch.models.gnn import GNNConfig

TEMPLATE = GNNConfig(
    name="graphsage-reddit",
    kind="sage",
    n_layers=2,
    d_in=-1,  # per shape
    d_hidden=128,
    d_out=-1,
    aggregator="mean",
)

SMOKE = GNNConfig(
    name="graphsage-smoke", kind="sage", n_layers=2, d_in=16, d_hidden=8, d_out=3,
    aggregator="mean",
)


def cfg_for(dims) -> GNNConfig:
    return dataclasses.replace(TEMPLATE, d_in=dims["d_feat"], d_out=dims["classes"])


def spec() -> ArchSpec:
    return ArchSpec(
        name="graphsage-reddit",
        family="gnn",
        model_cfg=TEMPLATE,
        smoke_cfg=SMOKE,
        shapes=GNN_SHAPES,
        skip={},
        notes="paper technique applies directly (k-hop window aggregation)",
    )

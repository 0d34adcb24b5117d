"""gcn-cora — [arXiv:1609.02907; paper].

2 layers, d_hidden=16, mean/sym-norm aggregator.
"""

import dataclasses

from repro_torch.configs.registry import GNN_SHAPES, ArchSpec
from repro_torch.models.gnn import GNNConfig

TEMPLATE = GNNConfig(
    name="gcn-cora",
    kind="gcn",
    n_layers=2,
    d_in=-1,
    d_hidden=16,
    d_out=-1,
    aggregator="mean",
)

SMOKE = GNNConfig(
    name="gcn-smoke", kind="gcn", n_layers=2, d_in=12, d_hidden=8, d_out=3,
)


def cfg_for(dims) -> GNNConfig:
    return dataclasses.replace(TEMPLATE, d_in=dims["d_feat"], d_out=dims["classes"])


def spec() -> ArchSpec:
    return ArchSpec(
        name="gcn-cora",
        family="gnn",
        model_cfg=TEMPLATE,
        smoke_cfg=SMOKE,
        shapes=GNN_SHAPES,
        skip={},
        notes="1-hop window with sym-norm weights == GCN propagate",
    )

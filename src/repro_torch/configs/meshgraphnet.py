"""meshgraphnet — [arXiv:2010.03409; unverified].

15 processor layers, d_hidden=128, sum aggregator, 2-layer MLPs.
Regression head (node targets); near-regular mesh graphs mean the paper's
dense-block sharing gain is small here (DESIGN.md §4) — supported, measured.
"""

import dataclasses

from repro_torch.configs.registry import GNN_SHAPES, ArchSpec
from repro_torch.models.gnn import GNNConfig

TEMPLATE = GNNConfig(
    name="meshgraphnet",
    kind="meshgraphnet",
    n_layers=15,
    d_in=-1,
    d_hidden=128,
    d_out=2,
    aggregator="sum",
    mlp_layers=2,
)

SMOKE = GNNConfig(
    name="meshgraphnet-smoke", kind="meshgraphnet", n_layers=3, d_in=8,
    d_hidden=16, d_out=2, aggregator="sum",
)


def cfg_for(dims) -> GNNConfig:
    return dataclasses.replace(TEMPLATE, d_in=dims["d_feat"])


def spec() -> ArchSpec:
    return ArchSpec(
        name="meshgraphnet",
        family="gnn",
        model_cfg=TEMPLATE,
        smoke_cfg=SMOKE,
        shapes=GNN_SHAPES,
        skip={},
    )

"""Central architecture registry, over the archs the port serves.

Every ported architecture registers an :class:`ArchSpec`:

* ``model_cfg`` — the exact public config (full scale),
* ``smoke_cfg`` — reduced same-family config for CPU tests,
* ``shapes``    — the arch's own input-shape set (:class:`ShapeCase`),
* ``skip``      — shape -> reason.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict

ARCH_MODULES = {
    "minitron-4b": "repro_torch.configs.minitron_4b",
    "qwen3-0.6b": "repro_torch.configs.qwen3_0p6b",
    "minitron-8b": "repro_torch.configs.minitron_8b",
    "grok-1-314b": "repro_torch.configs.grok1_314b",
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a2p7b",
    "graphsage-reddit": "repro_torch.configs.graphsage_reddit",
    "meshgraphnet": "repro_torch.configs.meshgraphnet",
    "gcn-cora": "repro_torch.configs.gcn_cora",
    "gat-cora": "repro_torch.configs.gat_cora",
    "fm": "repro_torch.configs.fm_criteo",
    "paper-gwq": "repro_torch.configs.paper_gwq",
}


@dataclasses.dataclass(frozen=True)
class ShapeCase:
    name: str
    kind: str  # train | prefill | decode | serve | retrieval
    dims: Dict[str, int]
    comment: str = ""


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    name: str
    family: str  # lm-dense | lm-moe | gnn | recsys | paper
    model_cfg: Any
    smoke_cfg: Any
    shapes: Dict[str, ShapeCase]
    skip: Dict[str, str]
    notes: str = ""


_cache: Dict[str, ArchSpec] = {}


def get_arch(name: str) -> ArchSpec:
    if name not in _cache:
        _cache[name] = importlib.import_module(ARCH_MODULES[name]).spec()
    return _cache[name]


def ARCHS():
    """The archs the port registers, in the reference's order."""
    return list(ARCH_MODULES)


# ----------------------- shared shape tables --------------------------- #
LM_SHAPES = {
    "train_4k": ShapeCase("train_4k", "train", dict(seq=4096, batch=256)),
    "prefill_32k": ShapeCase("prefill_32k", "prefill", dict(seq=32768, batch=32)),
    "decode_32k": ShapeCase("decode_32k", "decode", dict(seq=32768, batch=128)),
    "long_500k": ShapeCase("long_500k", "decode", dict(seq=524288, batch=1),
                           "long-context decode; needs sub-quadratic attention"),
}

GNN_SHAPES = {
    "full_graph_sm": ShapeCase(
        "full_graph_sm", "train", dict(n=2708, e=10556, d_feat=1433, classes=7)
    ),
    "minibatch_lg": ShapeCase(
        "minibatch_lg", "train",
        dict(n=232965, e=114615892, batch_nodes=1024, fan1=15, fan2=10,
             d_feat=602, classes=41,
             sub_n=1024 * (1 + 15 + 150), sub_e=1024 * 15 + 1024 * 150),
        "sampled training: device sees the padded sampled subgraph",
    ),
    "ogb_products": ShapeCase(
        "ogb_products", "train", dict(n=2449029, e=61859140, d_feat=100, classes=47)
    ),
    "molecule": ShapeCase(
        "molecule", "train", dict(n=30, e=64, batch=128, d_feat=16, classes=1)
    ),
}

RECSYS_SHAPES = {
    "train_batch": ShapeCase("train_batch", "train", dict(batch=65536)),
    "serve_p99": ShapeCase("serve_p99", "serve", dict(batch=512)),
    "serve_bulk": ShapeCase("serve_bulk", "serve", dict(batch=262144)),
    "retrieval_cand": ShapeCase(
        "retrieval_cand", "retrieval", dict(batch=1, n_candidates=1_000_000)
    ),
}

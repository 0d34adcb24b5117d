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
    "qwen3-0.6b": "repro_torch.configs.qwen3_0p6b",
    "fm": "repro_torch.configs.fm_criteo",
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
    family: str  # lm-dense | recsys
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


# ----------------------- shared shape tables --------------------------- #
LM_SHAPES = {
    "train_4k": ShapeCase("train_4k", "train", dict(seq=4096, batch=256)),
    "prefill_32k": ShapeCase("prefill_32k", "prefill", dict(seq=32768, batch=32)),
    "decode_32k": ShapeCase("decode_32k", "decode", dict(seq=32768, batch=128)),
    "long_500k": ShapeCase("long_500k", "decode", dict(seq=524288, batch=1),
                           "long-context decode; needs sub-quadratic attention"),
}

RECSYS_SHAPES = {
    "train_batch": ShapeCase("train_batch", "train", dict(batch=65536)),
    "serve_p99": ShapeCase("serve_p99", "serve", dict(batch=512)),
    "serve_bulk": ShapeCase("serve_bulk", "serve", dict(batch=262144)),
    "retrieval_cand": ShapeCase(
        "retrieval_cand", "retrieval", dict(batch=1, n_candidates=1_000_000)
    ),
}

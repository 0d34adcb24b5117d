"""Core of the paper: graph window queries, DBIndex, I-Index, baselines."""

from repro_torch.core.aggregates import AGGREGATES, register_aggregate  # noqa: F401
from repro_torch.core.api import (  # noqa: F401
    DEFAULT_REGISTRY,
    EngineCapability,
    EngineRegistry,
    QuerySpec,
    Session,
    UnsupportedQueryError,
    compile_queries,
)
from repro_torch.core.graph import DeviceGraph, Graph  # noqa: F401
from repro_torch.core.windows import (  # noqa: F401
    Diff,
    Filter,
    Intersect,
    KHop,
    KHopWindow,
    Topo,
    TopologicalWindow,
    Union,
    WindowExpr,
    canonicalize,
)

"""repro_torch: graph window analytics over dynamic graphs, on PyTorch/CUDA.

The PyTorch port of :mod:`repro` (Fan, Wang, Chan, Tan 2015: graph window
queries, the Dense Block Index, the Inheritance Index), with hand-written
Hopper kernels for the query and update data planes.  The host builders
are NumPy; device plans are torch tensors on an explicit device, and every
entry point runs on the card unless the caller passes
``torch_device="cpu"``.

Public API is re-exported lazily to keep ``import repro_torch`` cheap.
"""

__version__ = "0.1.0"

_LAZY = {
    "Graph": "repro_torch.core.graph",
    "DeviceGraph": "repro_torch.core.graph",
    "KHopWindow": "repro_torch.core.windows",
    "TopologicalWindow": "repro_torch.core.windows",
    "KHop": "repro_torch.core.windows",
    "Topo": "repro_torch.core.windows",
    "Union": "repro_torch.core.windows",
    "Intersect": "repro_torch.core.windows",
    "Diff": "repro_torch.core.windows",
    "Filter": "repro_torch.core.windows",
    "WindowExpr": "repro_torch.core.windows",
    "canonicalize": "repro_torch.core.windows",
    "DBIndex": "repro_torch.core.dbindex",
    "build_dbindex": "repro_torch.core.dbindex",
    "IIndex": "repro_torch.core.iindex",
    "build_iindex": "repro_torch.core.iindex",
    "AGGREGATES": "repro_torch.core.aggregates",
    "register_aggregate": "repro_torch.core.aggregates",
    "QuerySpec": "repro_torch.core.api",
    "Session": "repro_torch.core.api",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(_LAZY[name])
        return getattr(mod, name)
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY))

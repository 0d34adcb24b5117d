"""Graph Window Query facade (paper Definition 3) — thin legacy shim.

The engine dispatch now lives in :mod:`repro_torch.core.api`: backends
register :class:`~repro_torch.core.api.EngineCapability` objects with the
:data:`~repro_torch.core.api.DEFAULT_REGISTRY`, and selection is by declared
capability rather than an if/elif chain.  ``GraphWindowQuery.run`` is kept
as a one-query convenience over that registry; new code should use
:class:`repro_torch.core.api.QuerySpec` +
:class:`repro_torch.core.api.Session` (which fuse multi-aggregate queries
and survive update streams).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.aggregates import AGGREGATES
from repro_torch.core.graph import Graph
from repro_torch.core.windows import KHopWindow, TopologicalWindow


@dataclasses.dataclass(frozen=True)
class GraphWindowQuery:
    """A single graph window function (G, W, Σ, A)."""

    window: object  # KHopWindow | TopologicalWindow
    agg: str = "sum"
    attr: str = "val"

    def __post_init__(self):
        assert self.agg in AGGREGATES, f"unknown aggregate {self.agg}"

    def run(
        self,
        g: Graph,
        engine: str = "dbindex",
        index: Optional[object] = None,
        **kw,
    ) -> np.ndarray:
        from repro_torch.core.api import DEFAULT_REGISTRY

        out = DEFAULT_REGISTRY.run(
            engine, g, self.window, g.attrs[self.attr], (self.agg,),
            index=index, **kw,
        )
        return np.asarray(out[self.agg])


def brute_force(g: Graph, window, values: np.ndarray, agg: str = "sum",
                dtype=None) -> np.ndarray:
    """Reference oracle used by property tests — independent code path.

    Per-vertex *set evaluation*: one frontier BFS per leaf, NumPy set ops
    per combinator (:func:`~repro_torch.core.windows.expr_window_single`),
    then a direct monoid reduce over the member set — no bitsets, no blocks, no
    sharing.  ``dtype`` pins the channel dtype (e.g. ``np.float32`` to
    differentially match a device engine bit-for-bit on integer-valued
    attributes: every partial is an exact integer, so evaluation order is
    irrelevant and the finalizer is the only rounding step on both sides).
    """
    from repro_torch.core.windows import (
        expr_window_single,
        khop_window_single,
        topological_window_single,
    )

    a = AGGREGATES[agg]
    chans = a.prepare(np.asarray(values))
    if dtype is not None:
        chans = tuple(c.astype(dtype) for c in chans)
    idents = [m.identity_for(c.dtype) for m, c in zip(a.monoids, chans)]
    outs = [np.full(g.n, i, dtype=c.dtype) for i, c in zip(idents, chans)]
    for v in range(g.n):
        if isinstance(window, KHopWindow):
            w = khop_window_single(g, window.k, v)
        elif isinstance(window, TopologicalWindow):
            w = topological_window_single(g, v)
        else:
            w = expr_window_single(g, window, v)
        for o, m, c, i in zip(outs, a.monoids, chans, idents):
            o[v] = m.np_op.reduce(c[w]) if w.size else i
    return a.finalize_np(*outs)

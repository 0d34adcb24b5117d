"""Non-indexed baseline (paper §4 intro, §6.1).

Computes ``W(v)`` and its aggregate independently for every vertex — a
k-bounded BFS per vertex for k-hop windows, a reverse reachability sweep for
topological windows.  Two variants:

* :func:`query_pervertex` — the paper's literal baseline (per-vertex BFS),
  intentionally unshared; used for the four-orders-of-magnitude comparison.
* :func:`query_batched_bitset` — our vectorized lower bound for a fair "best
  non-index" comparison (batched bitset BFS + masked aggregation).  Serves
  composite :class:`~repro_torch.core.windows.WindowExpr` windows too: a
  combinator is one bitwise op over the packed reachability matrices.

Both are dtype-safe: integer attributes ride integer monoid channels with
per-dtype identities (no silent float upcast; finalizers may change dtype).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.aggregates import AGGREGATES
from repro_torch.core.graph import Graph
from repro_torch.core.windows import (
    KHopWindow,
    TopologicalWindow,
    expr_reach_bitsets,
    khop_window_single,
    topological_window_single,
    topological_windows,
)

Array = np.ndarray


def query_pervertex(g: Graph, window, values: Array, agg: str = "sum",
                    limit: int | None = None) -> Array:
    """Aggregate per window with zero sharing.  `limit` caps the number of
    vertices processed (for benchmark extrapolation, paper-style)."""
    a = AGGREGATES[agg]
    chans = a.prepare(np.asarray(values))
    n = g.n if limit is None else min(g.n, limit)
    idents = [m.identity_for(c.dtype) for m, c in zip(a.monoids, chans)]
    outs = [np.full(g.n, i, dtype=c.dtype) for i, c in zip(idents, chans)]
    for v in range(n):
        if isinstance(window, KHopWindow):
            w = khop_window_single(g, window.k, v)
        elif isinstance(window, TopologicalWindow):
            w = topological_window_single(g, v)
        else:
            raise TypeError(window)
        for o, m, c, i in zip(outs, a.monoids, chans, idents):
            o[v] = m.np_op.reduce(c[w]) if w.size else i
    return a.finalize_np(*outs)


def query_batched_bitset(g: Graph, window, values: Array, agg: str = "sum") -> Array:
    """Vectorized non-index evaluation via packed reachability bitsets.

    Any window expression is served: leaves are batched bitset BFS runs and
    combinators are single vectorized bitwise ops on the packed matrices
    (:func:`~repro_torch.core.windows.expr_reach_bitsets`), so this doubles as the
    fast independent evaluation path for composite windows.
    """
    a = AGGREGATES[agg]
    chans = a.prepare(np.asarray(values))
    idents = [m.identity_for(c.dtype) for m, c in zip(a.monoids, chans)]
    outs = [np.full(g.n, i, dtype=c.dtype) for i, c in zip(idents, chans)]
    if isinstance(window, TopologicalWindow):
        wins = topological_windows(g)
        for v, w in enumerate(wins):
            for o, m, c, i in zip(outs, a.monoids, chans, idents):
                o[v] = m.np_op.reduce(c[w]) if w.size else i
        return a.finalize_np(*outs)
    batch = 2048
    for lo in range(0, g.n, batch):
        srcs = np.arange(lo, min(lo + batch, g.n), dtype=np.int32)
        reach = expr_reach_bitsets(g, window, srcs)  # [n, words]
        bits = np.unpackbits(
            reach.view(np.uint8), axis=1, bitorder="little"
        )[:, : srcs.size].astype(bool)  # [n, B] member x source
        for o, m, c, i in zip(outs, a.monoids, chans, idents):
            vals = np.where(bits, c[:, None], i)
            o[srcs] = m.np_op.reduce(vals, axis=0)
    return a.finalize_np(*outs)

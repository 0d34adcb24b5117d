"""Topological windows (the paper's Definition 2): the vertex and all of
its ancestors in a DAG.

The windows are held as a dense ancestor-or-self matrix ``R`` (``R[v, u]``
is 1 when ``u`` lies in ``v``'s window), built level by level from the
roots: a vertex's row is its own bit and the union of its parents' rows.
Sums and counts are row blocks of ``R`` times the value columns; min and
max follow the same recursion over the levels, since they are idempotent.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch


@dataclasses.dataclass
class Windows:
    n: int
    reach: torch.Tensor  # uint8 [n, n], 0 or 1
    # per level from 1 up: (parents, children) of the edges into that level
    level_edges: List[tuple]


def levels(graph) -> np.ndarray:
    """Each vertex's longest-path distance from a root; raises on a
    cycle."""
    n = graph.n
    src, dst = graph.src.astype(np.int64), graph.dst.astype(np.int64)
    order = np.argsort(src, kind="stable")
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(src, minlength=n), out=indptr[1:])
    children = dst[order]
    indeg = np.bincount(dst, minlength=n)
    level = np.full(n, -1, np.int64)
    frontier = np.flatnonzero(indeg == 0)
    depth = 0
    while frontier.size:
        level[frontier] = depth
        deg = indptr[frontier + 1] - indptr[frontier]
        starts = np.repeat(indptr[frontier] - np.cumsum(deg) + deg, deg)
        kids, cnt = np.unique(children[starts + np.arange(int(deg.sum()))],
                              return_counts=True)
        indeg[kids] -= cnt
        frontier = kids[indeg[kids] == 0]
        depth += 1
    if (level < 0).any():
        raise ValueError("the graph has a cycle: no topological windows")
    return level


def prepare(graph, window: dict, device) -> Windows:
    n = graph.n
    level = levels(graph)
    src, dst = graph.src.astype(np.int64), graph.dst.astype(np.int64)
    by = np.argsort(level[dst], kind="stable")
    src, dst = src[by], dst[by]
    cuts = np.searchsorted(level[dst], np.arange(1, level.max() + 2))
    reach = torch.zeros(n, n, dtype=torch.uint8, device=device)
    diag = torch.arange(n, device=device)
    reach[diag, diag] = 1
    level_edges = []
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        p = torch.from_numpy(src[lo:hi]).to(device)
        c = torch.from_numpy(dst[lo:hi]).to(device)
        kids = torch.unique(c)
        reach.index_put_((c,), reach[p], accumulate=True)
        reach[kids] = reach[kids].clamp_(max=1)
        level_edges.append((p, c))
    return Windows(n, reach, level_edges)


def reduce(w: Windows, x: torch.Tensor, dtype, rows: int = 4096) -> dict:
    """Window sum, count, min and max of each column of ``x`` (``[n, B]``,
    already in ``dtype``), each ``[n, B]``; ``rows`` rows of ``R`` at a
    time."""
    n, b = x.shape
    total = torch.empty(n, b, dtype=dtype, device=x.device)
    count = torch.empty(n, dtype=dtype, device=x.device)
    for lo in range(0, n, rows):
        blk = w.reach[lo:lo + rows].to(dtype)
        total[lo:lo + rows] = blk @ x
        count[lo:lo + rows] = blk.sum(1)
        del blk
    # min and max in one pass: max(x) = -min(-x)
    low = torch.cat([x, -x], dim=1)
    for p, c in w.level_edges:
        low.scatter_reduce_(0, c[:, None].expand(-1, 2 * b), low[p], "amin")
    return {"sum": total, "count": count[:, None].expand(-1, b),
            "min": low[:, :b], "max": -low[:, b:]}

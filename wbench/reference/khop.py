"""k-hop windows (the paper's Definition 1): the vertex and every vertex
within ``k`` hops along out-edges, both directions on an undirected graph.

The windows are listed as (owner, member) pairs by joining the pairs with
the adjacency ``k`` times and keeping the distinct ones; the aggregates
are gathers and scatters over those pairs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Windows:
    n: int
    owner: torch.Tensor  # int64 [P], sorted
    member: torch.Tensor  # int64 [P]


def adjacency(graph, device) -> tuple:
    """CSR ``(indptr, indices)`` of each vertex's neighbours along
    out-edges (both directions when the graph is undirected)."""
    src, dst = graph.src.astype(np.int64), graph.dst.astype(np.int64)
    if not graph.directed:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    order = np.argsort(src, kind="stable")
    indptr = np.zeros(graph.n + 1, np.int64)
    np.cumsum(np.bincount(src, minlength=graph.n), out=indptr[1:])
    return torch.from_numpy(indptr).to(device), torch.from_numpy(dst[order]).to(device)


def window_keys(graph, k: int, device) -> torch.Tensor:
    """``owner * n + member`` of every vertex's ``k``-hop window, sorted:
    ``k`` times, each pair (o, m) is joined by every (o, w) with ``w`` a
    neighbour of ``m``, and the distinct pairs kept."""
    n = graph.n
    indptr, indices = adjacency(graph, device)
    keys = torch.arange(n, device=device) * (n + 1)
    for _ in range(k):
        owner, member = keys // n, keys % n
        deg = indptr[member + 1] - indptr[member]
        first = torch.repeat_interleave(indptr[member] - torch.cumsum(deg, 0) + deg, deg)
        w = indices[first + torch.arange(first.numel(), device=device)]
        keys = torch.unique(torch.cat([keys, torch.repeat_interleave(owner, deg) * n + w]))
    return keys


def prepare(graph, window: dict, device) -> Windows:
    keys = window_keys(graph, int(window["k"]), device)
    return Windows(graph.n, keys // graph.n, keys % graph.n)


def reduce(w: Windows, x: torch.Tensor, dtype, cols: int = 16) -> dict:
    """Window sum, count, min and max of each column of ``x`` (``[n, B]``,
    already in ``dtype``), each ``[n, B]``; ``cols`` columns at a time."""
    n, b = x.shape
    out = {"sum": torch.zeros(n, b, dtype=dtype, device=x.device),
           "min": torch.full((n, b), float("inf"), dtype=dtype, device=x.device),
           "max": torch.full((n, b), float("-inf"), dtype=dtype, device=x.device)}
    for lo in range(0, b, cols):
        part = x[:, lo:lo + cols][w.member]
        idx = w.owner[:, None].expand(-1, part.shape[1])
        out["sum"][:, lo:lo + cols].index_add_(0, w.owner, part)
        out["min"][:, lo:lo + cols].scatter_reduce_(0, idx, part, "amin")
        out["max"][:, lo:lo + cols].scatter_reduce_(0, idx, part, "amax")
        del part, idx
    ones = torch.ones(w.owner.numel(), dtype=dtype, device=x.device)
    count = torch.zeros(n, dtype=dtype, device=x.device).index_add_(0, w.owner, ones)
    out["count"] = count[:, None].expand(-1, b)
    return out

"""Graph containers.

Two tiers, mirroring DESIGN.md:

* :class:`Graph` — host-side (NumPy) container used by the index *builders*
  (the control plane).  Stores edges as COO plus cached CSR adjacency in both
  directions, vertex attributes, and DAG metadata when acyclic.
* :class:`DeviceGraph` — torch tensors on an explicit device for the query
  *data plane*:
  COO sorted by destination (the layout the fused gather+segment-reduce
  kernel consumes) plus CSR offsets.

All vertex ids are int32.  Graphs are immutable; structural updates produce
new `Graph` objects via :mod:`repro_torch.core.updates`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

Array = np.ndarray


def _build_csr(n: int, src: Array, dst: Array) -> Tuple[Array, Array]:
    """CSR over (src -> dst): returns (indptr [n+1], indices sorted by src)."""
    order = np.argsort(src, kind="stable")
    indices = dst[order].astype(np.int32)
    counts = np.bincount(src, minlength=n).astype(np.int64)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr, indices


@dataclasses.dataclass(frozen=True)
class Graph:
    """Immutable host-side graph.

    For undirected graphs, ``src``/``dst`` store each edge once; the
    symmetrized adjacency is materialized in the CSR caches.
    """

    n: int
    src: Array  # int32 [E]
    dst: Array  # int32 [E]
    directed: bool = True
    attrs: Dict[str, Array] = dataclasses.field(default_factory=dict)

    # caches (filled in __post_init__)
    out_indptr: Array = dataclasses.field(default=None, repr=False)
    out_indices: Array = dataclasses.field(default=None, repr=False)
    in_indptr: Array = dataclasses.field(default=None, repr=False)
    in_indices: Array = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        src = np.asarray(self.src, dtype=np.int32)
        dst = np.asarray(self.dst, dtype=np.int32)
        object.__setattr__(self, "src", src)
        object.__setattr__(self, "dst", dst)
        if src.size:
            assert src.min() >= 0 and src.max() < self.n, "src out of range"
            assert dst.min() >= 0 and dst.max() < self.n, "dst out of range"
        if self.directed:
            o_ptr, o_idx = _build_csr(self.n, src, dst)
            i_ptr, i_idx = _build_csr(self.n, dst, src)
        else:
            both_src = np.concatenate([src, dst])
            both_dst = np.concatenate([dst, src])
            o_ptr, o_idx = _build_csr(self.n, both_src, both_dst)
            i_ptr, i_idx = o_ptr, o_idx
        object.__setattr__(self, "out_indptr", o_ptr)
        object.__setattr__(self, "out_indices", o_idx)
        object.__setattr__(self, "in_indptr", i_ptr)
        object.__setattr__(self, "in_indices", i_idx)

    # ------------------------------------------------------------------ #
    @property
    def n_edges(self) -> int:
        return int(self.src.size)

    def out_neighbors(self, v: int) -> Array:
        return self.out_indices[self.out_indptr[v] : self.out_indptr[v + 1]]

    def in_neighbors(self, v: int) -> Array:
        return self.in_indices[self.in_indptr[v] : self.in_indptr[v + 1]]

    def degree_out(self) -> Array:
        return np.diff(self.out_indptr)

    def with_attr(self, name: str, values: Array) -> "Graph":
        values = np.asarray(values)
        assert values.shape[0] == self.n
        attrs = dict(self.attrs)
        attrs[name] = values
        return dataclasses.replace(self, attrs=attrs)

    def with_edges(self, src: Array, dst: Array) -> "Graph":
        """New graph, same vertices/attrs, different edge set."""
        return Graph(
            n=self.n,
            src=np.asarray(src, np.int32),
            dst=np.asarray(dst, np.int32),
            directed=self.directed,
            attrs=dict(self.attrs),
        )

    def reverse_view(self) -> "Graph":
        """Edge-flipped graph sharing this graph's CSR caches, O(1).

        The reverse adjacency already exists (``in_indptr``/``in_indices``),
        so the flipped view just swaps the cached arrays instead of paying
        ``__post_init__``'s edge sort + CSR builds — reverse traversals
        (topological oracles, affected-owner BFS, ``KHop(k, "in")`` leaves)
        sit in per-batch maintenance hot paths."""
        if not self.directed:
            return self
        rv = object.__new__(Graph)
        object.__setattr__(rv, "n", self.n)
        object.__setattr__(rv, "src", self.dst)
        object.__setattr__(rv, "dst", self.src)
        object.__setattr__(rv, "directed", True)
        object.__setattr__(rv, "attrs", self.attrs)
        object.__setattr__(rv, "out_indptr", self.in_indptr)
        object.__setattr__(rv, "out_indices", self.in_indices)
        object.__setattr__(rv, "in_indptr", self.out_indptr)
        object.__setattr__(rv, "in_indices", self.out_indices)
        return rv

    # --------------------------- edge keys ---------------------------- #
    def edge_keys(self, src: Optional[Array] = None, dst: Optional[Array] = None) -> Array:
        """Canonical int64 key per edge (orientation-insensitive when
        undirected).  Defaults to the graph's own edge list — the batch
        update machinery uses these for vectorized membership/deletion."""
        src = self.src if src is None else np.asarray(src, np.int64)
        dst = self.dst if dst is None else np.asarray(dst, np.int64)
        s = src.astype(np.int64)
        d = dst.astype(np.int64)
        if not self.directed:
            s, d = np.minimum(s, d), np.maximum(s, d)
        return s * np.int64(self.n) + d

    def contains_edges(self, src: Array, dst: Array) -> Array:
        """Boolean mask: is each (src[i], dst[i]) present in the edge list?"""
        return np.isin(self.edge_keys(src, dst), self.edge_keys())

    # ------------------------------ DAG ------------------------------- #
    def topological_order(self) -> Array:
        """Kahn's algorithm. Raises ValueError on cycles. Directed only."""
        if not self.directed:
            raise ValueError("topological order requires a directed graph")
        indeg = np.bincount(self.dst, minlength=self.n).astype(np.int64)
        order = np.empty(self.n, dtype=np.int32)
        frontier = np.flatnonzero(indeg == 0).astype(np.int32)
        pos = 0
        indeg = indeg.copy()
        while frontier.size:
            order[pos : pos + frontier.size] = frontier
            pos += frontier.size
            # decrement indegree of all out-neighbors of the frontier
            nbr = np.concatenate(
                [self.out_indices[self.out_indptr[v] : self.out_indptr[v + 1]] for v in frontier]
            ) if frontier.size < 4096 else self._frontier_out(frontier)
            if nbr.size == 0:
                frontier = np.empty(0, np.int32)
                continue
            dec = np.bincount(nbr, minlength=self.n)
            indeg -= dec
            frontier = np.flatnonzero((indeg == 0) & (dec > 0)).astype(np.int32)
        if pos != self.n:
            raise ValueError("graph has a cycle; not a DAG")
        return order

    def _frontier_out(self, frontier: Array) -> Array:
        starts = self.out_indptr[frontier]
        stops = self.out_indptr[frontier + 1]
        lens = stops - starts
        total = int(lens.sum())
        if total == 0:
            return np.empty(0, np.int32)
        out = np.empty(total, np.int32)
        # vectorized multi-slice copy via repeat/cumsum trick
        idx = np.repeat(starts, lens) + (
            np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens)
        )
        out[:] = self.out_indices[idx]
        return out

    def dag_levels(self) -> Array:
        """level[v] = longest path length from any source to v (0-based)."""
        order = self.topological_order()
        level = np.zeros(self.n, dtype=np.int32)
        for v in order:
            nbr = self.out_neighbors(v)
            if nbr.size:
                np.maximum.at(level, nbr, level[v] + 1)
        return level

    def is_dag(self) -> bool:
        try:
            self.topological_order()
            return True
        except ValueError:
            return False


# ---------------------------------------------------------------------- #
#  Device-side representation
# ---------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class DeviceGraph:
    """Torch tensors for the query data plane, on an explicit device.

    ``edge_src``/``edge_dst`` are sorted by ``edge_dst`` so that segment
    reductions into the destination vertex see contiguous segment ids.  For
    undirected graphs the edge list is pre-symmetrized.  Padding edges (if
    any) point at vertex id ``n`` (one-past-the-end sink row).
    """

    n: int
    n_edges: int  # valid edges (pre-padding)
    edge_src: "torch.Tensor"  # int32 [E_pad]
    edge_dst: "torch.Tensor"  # int32 [E_pad], sorted ascending
    device: "torch.device"
    attrs: Dict[str, "torch.Tensor"] = dataclasses.field(default_factory=dict)

    @staticmethod
    def from_graph(g: Graph, pad_to: Optional[int] = None,
                   torch_device="cuda") -> "DeviceGraph":
        import torch

        from repro_torch.device import resolve_device

        dev = resolve_device(torch_device)
        if g.directed:
            src, dst = g.src, g.dst
        else:
            src = np.concatenate([g.src, g.dst])
            dst = np.concatenate([g.dst, g.src])
        order = np.argsort(dst, kind="stable")
        src, dst = src[order], dst[order]
        e = src.size
        pad_to = pad_to or e
        assert pad_to >= e
        if pad_to > e:
            src = np.pad(src, (0, pad_to - e), constant_values=g.n)
            dst = np.pad(dst, (0, pad_to - e), constant_values=g.n)
        attrs = {k: torch.as_tensor(np.asarray(v), device=dev)
                 for k, v in g.attrs.items()}
        return DeviceGraph(
            n=g.n,
            n_edges=e,
            edge_src=torch.as_tensor(src.astype(np.int32), device=dev),
            edge_dst=torch.as_tensor(dst.astype(np.int32), device=dev),
            device=dev,
            attrs=attrs,
        )

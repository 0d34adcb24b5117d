"""Synthetic graph generators.

Mirrors the paper's experimental setup: SNAP-style Erdős–Rényi graphs of a
given average degree (§6.2.2 "Degree means average degree... Erdos-Renyi
model"), power-law (Barabási–Albert) social-network-shaped graphs, and
DAGGER-style random DAGs (§6.3).  Plus the shapes the assigned architecture
pool needs: 2-D triangulated meshes (MeshGraphNet), batched small molecule
graphs, and Cora/Reddit/OGB-shaped stand-ins.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.core.graph import Graph


def _dedupe(src: np.ndarray, dst: np.ndarray, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Drop self-loops and duplicate edges."""
    keep = src != dst
    src, dst = src[keep], dst[keep]
    key = src.astype(np.int64) * n + dst
    _, idx = np.unique(key, return_index=True)
    return src[np.sort(idx)], dst[np.sort(idx)]


def erdos_renyi(n: int, avg_degree: float, directed: bool = False, seed: int = 0) -> Graph:
    """G(n, m) with m = n*avg_degree/(2 if undirected else 1) edges."""
    rng = np.random.default_rng(seed)
    m = int(n * avg_degree / (1 if directed else 2))
    src = rng.integers(0, n, size=int(m * 1.15), dtype=np.int64).astype(np.int32)
    dst = rng.integers(0, n, size=int(m * 1.15), dtype=np.int64).astype(np.int32)
    src, dst = _dedupe(src, dst, n)
    src, dst = src[:m], dst[:m]
    return Graph(n=n, src=src, dst=dst, directed=directed)


def barabasi_albert(n: int, m_attach: int = 4, seed: int = 0) -> Graph:
    """Preferential attachment (power-law degrees) — social-network shaped."""
    rng = np.random.default_rng(seed)
    src_l, dst_l = [], []
    targets = list(range(m_attach))
    repeated: list = list(range(m_attach))
    for v in range(m_attach, n):
        chosen = rng.choice(len(repeated), size=m_attach, replace=False)
        chosen_t = {repeated[c] for c in chosen}
        for t in chosen_t:
            src_l.append(v)
            dst_l.append(t)
            repeated.append(t)
            repeated.append(v)
    src = np.array(src_l, dtype=np.int32)
    dst = np.array(dst_l, dtype=np.int32)
    return Graph(n=n, src=src, dst=dst, directed=False)


def random_dag(n: int, avg_degree: float, seed: int = 0, locality: int = 0) -> Graph:
    """DAGGER-style random DAG: edges go from lower to higher topological
    rank.  `locality` > 0 limits edge span (pathway-graph shaped)."""
    rng = np.random.default_rng(seed)
    m = int(n * avg_degree)
    lo = rng.integers(0, n - 1, size=int(m * 1.2), dtype=np.int64)
    if locality > 0:
        span = rng.integers(1, locality + 1, size=lo.size)
        hi = np.minimum(lo + span, n - 1)
    else:
        hi = rng.integers(1, n, size=lo.size, dtype=np.int64)
        lo, hi = np.minimum(lo, hi), np.maximum(lo, hi)
    keep = lo != hi
    lo, hi = lo[keep], hi[keep]
    src, dst = _dedupe(lo.astype(np.int32), hi.astype(np.int32), n)
    src, dst = src[:m], dst[:m]
    # random relabel so vertex id != topological rank
    perm = rng.permutation(n).astype(np.int32)
    return Graph(n=n, src=perm[src], dst=perm[dst], directed=True)


def grid_mesh(rows: int, cols: int) -> Graph:
    """Triangulated 2-D grid (MeshGraphNet-shaped)."""
    n = rows * cols
    idx = np.arange(n).reshape(rows, cols)
    right = np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], 0)
    down = np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], 0)
    diag = np.stack([idx[:-1, :-1].ravel(), idx[1:, 1:].ravel()], 0)
    e = np.concatenate([right, down, diag], axis=1).astype(np.int32)
    return Graph(n=n, src=e[0], dst=e[1], directed=False)


def batched_molecules(
    batch: int, nodes_per: int = 30, edges_per: int = 64, seed: int = 0
) -> Tuple[Graph, np.ndarray]:
    """`batch` disjoint small random graphs; returns (graph, graph_id[n])."""
    rng = np.random.default_rng(seed)
    srcs, dsts = [], []
    for b in range(batch):
        s = rng.integers(0, nodes_per, size=edges_per * 2, dtype=np.int64)
        d = rng.integers(0, nodes_per, size=edges_per * 2, dtype=np.int64)
        s, d = _dedupe(s.astype(np.int32), d.astype(np.int32), nodes_per)
        s, d = s[:edges_per], d[:edges_per]
        srcs.append(s + b * nodes_per)
        dsts.append(d + b * nodes_per)
    g = Graph(
        n=batch * nodes_per,
        src=np.concatenate(srcs),
        dst=np.concatenate(dsts),
        directed=False,
    )
    graph_id = np.repeat(np.arange(batch, dtype=np.int32), nodes_per)
    return g, graph_id


def with_random_attrs(g: Graph, seed: int = 0, names=("val",)) -> Graph:
    rng = np.random.default_rng(seed)
    for name in names:
        g = g.with_attr(name, rng.integers(0, 100, size=g.n).astype(np.float64))
    return g

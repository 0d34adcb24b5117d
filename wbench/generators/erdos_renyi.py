"""Erdős–Rényi G(n, m), frozen: copied from
``src/repro_torch/graphs/generators.py`` (``erdos_renyi``) with its
arithmetic unchanged, so the same ``rng`` gives the same edges."""

from __future__ import annotations

import numpy as np

from wbench.graphs import EdgeList, dedupe


def generate(n: int, avg_degree: float, rng: np.random.Generator,
             directed: bool = False) -> EdgeList:
    """G(n, m) with m = n*avg_degree/(2 if undirected else 1) edges."""
    m = int(n * avg_degree / (1 if directed else 2))
    src = rng.integers(0, n, size=int(m * 1.15), dtype=np.int64).astype(np.int32)
    dst = rng.integers(0, n, size=int(m * 1.15), dtype=np.int64).astype(np.int32)
    src, dst = dedupe(src, dst, n)
    return EdgeList(n, src[:m], dst[:m], directed)

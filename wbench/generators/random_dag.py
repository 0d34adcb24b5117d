"""DAGGER-style random DAG, frozen: copied from
``src/repro_torch/graphs/generators.py`` (``random_dag``) with its
arithmetic unchanged, so the same ``rng`` gives the same edges."""

from __future__ import annotations

import numpy as np

from wbench.graphs import EdgeList, dedupe


def generate(n: int, avg_degree: float, rng: np.random.Generator,
             locality: int = 0) -> EdgeList:
    """Edges go from lower to higher topological rank.  ``locality`` > 0
    limits edge span (pathway-graph shaped)."""
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
    src, dst = dedupe(lo.astype(np.int32), hi.astype(np.int32), n)
    src, dst = src[:m], dst[:m]
    # random relabel so vertex id != topological rank
    perm = rng.permutation(n).astype(np.int32)
    return EdgeList(n, perm[src], perm[dst], True)

"""Inheritance Index (paper §5) for topological windows on DAGs.

Exploits the containment theorem (5.1): ``W_t(parent) ⊂ W_t(child)``.  Each
vertex stores

* ``PID(v)`` — the *closest* parent = parent with the largest window
  cardinality (ties broken arbitrarily; paper Algorithm 4 lines 7-12),
* ``WD(v)`` — the window difference ``W_t(v) \\ W_t(PID(v))`` (always
  contains ``v`` itself; equals ``{v} ∪ ancestors`` for sources).

Query (Algorithm 5): one sweep in topological order,
``Σ(W_t(v)) = Σ( Σ(W_t(PID(v))), Σ(WD(v)) )``.

Device adaptation (DESIGN.md §2): the sequential scan is *level-scheduled* —
``level(v) = 1 + level(PID(v))`` along the PID forest, every level is one
fused gather+segment-reduce + one gather of the parents' finished aggregates,
preserving the paper's inheritance reuse while exposing data parallelism.
The difference aggregates ``Σ(WD(v))`` for *all* vertices are a single
segment-reduce (they don't depend on the scan), so the device plan is:

    wd_partial = segment_reduce(values[wd_members], wd_owner)      # once
    for level in 1..depth:  agg[v] = op(agg[PID(v)], wd_partial[v])

An optional *pointer-doubling* schedule (O(log depth) gathers) is provided
for deep chains — used by the §Perf hillclimb.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import numpy as np

from repro_torch.core.aggregates import AGGREGATES
from repro_torch.core.graph import Graph

Array = np.ndarray


@dataclasses.dataclass(frozen=True)
class IIndex:
    n: int
    pid: Array  # int32 [n]; -1 for sources of the PID forest
    wd_members: Array  # int32 [D] concatenated window differences
    wd_offsets: Array  # int64 [n+1]
    level: Array  # int32 [n]: depth along the PID forest (0 for roots)
    topo_order: Array  # int32 [n]
    stats: Dict = dataclasses.field(default_factory=dict, repr=False)

    def wd(self, v: int) -> Array:
        return self.wd_members[self.wd_offsets[v] : self.wd_offsets[v + 1]]

    def window_of(self, v: int) -> Array:
        """Reconstruct W_t(v) by walking the PID chain (invariant tests)."""
        parts = []
        u = int(v)
        while u != -1:
            parts.append(self.wd(u))
            u = int(self.pid[u])
        return np.sort(np.concatenate(parts)) if parts else np.empty(0, np.int32)

    def size_bytes(self) -> int:
        return int(self.pid.nbytes + self.wd_members.nbytes + self.wd_offsets.nbytes)

    # ------------------------- query (NumPy) ------------------------- #
    def query(self, values: Array, agg: str = "sum") -> Array:
        a = AGGREGATES[agg]
        chans = a.prepare(np.asarray(values))
        outs = []
        for monoid, chan in zip(a.monoids, chans):
            ident = monoid.identity_for(chan.dtype)  # dtype-safe (no upcast)
            # Σ(WD(v)) for all v in one reduceat
            wdp = np.full(self.n, ident, dtype=chan.dtype)
            if self.wd_members.size:
                starts = self.wd_offsets[:-1]
                nonempty = np.diff(self.wd_offsets) > 0
                red = monoid.np_op.reduceat(
                    chan[self.wd_members], np.minimum(starts, self.wd_members.size - 1)
                )
                wdp = np.where(nonempty, red, ident)
            ans = wdp.copy()
            for v in self.topo_order:  # inherit parent's finished aggregate
                p = self.pid[v]
                if p != -1:
                    ans[v] = monoid.np_op(ans[v], ans[p])
            outs.append(ans)
        return a.finalize_np(*outs)


def build_iindex(g: Graph, max_live_bytes: int = 2 * 2**30) -> IIndex:
    """Paper Algorithm 4 with bitset windows + liveness-based freeing.

    A vertex's ancestor bitset is dropped as soon as its last child has
    consumed it (the paper's "release memory" step), so peak memory tracks
    the widest live antichain rather than |V| windows.
    """
    t0 = time.perf_counter()
    order = g.topological_order()
    words = (g.n + 63) // 64
    live: Dict[int, Array] = {}
    remaining_children = np.diff(g.out_indptr).astype(np.int64).copy()
    pid = np.full(g.n, -1, dtype=np.int32)
    card = np.zeros(g.n, dtype=np.int64)
    wd_lists: List[Array] = [None] * g.n  # type: ignore

    for v in order:
        v = int(v)
        parents = g.in_neighbors(v)
        # closest parent = parent with max |W_t(parent)|
        best, best_c = -1, -1
        for p in parents:
            if card[p] > best_c:
                best_c, best = int(card[p]), int(p)
        own = np.zeros(words, dtype=np.uint64)
        own[v // 64] |= np.uint64(1) << np.uint64(v % 64)
        for p in parents:
            own |= live[int(p)]
        if best != -1:
            diff = own & ~live[best]
        else:
            diff = own
        wd_lists[v] = np.flatnonzero(
            np.unpackbits(diff.view(np.uint8), bitorder="little")[: g.n]
        ).astype(np.int32)
        pid[v] = best
        card[v] = int(
            np.unpackbits(own.view(np.uint8), bitorder="little")[: g.n].sum()
        )
        live[v] = own
        for p in parents:
            p = int(p)
            remaining_children[p] -= 1
            if remaining_children[p] == 0:
                del live[p]
        if remaining_children[v] == 0:
            # leaf: nobody will consume it
            del live[v]

    sizes = np.array([w.size for w in wd_lists], dtype=np.int64)
    wd_offsets = np.zeros(g.n + 1, dtype=np.int64)
    np.cumsum(sizes, out=wd_offsets[1:])
    wd_members = (
        np.concatenate(wd_lists) if g.n else np.empty(0, np.int32)
    ).astype(np.int32)

    # level along PID forest
    level = np.zeros(g.n, dtype=np.int32)
    for v in order:
        p = pid[v]
        if p != -1:
            level[v] = level[p] + 1

    stats = {
        "t_total_s": time.perf_counter() - t0,
        "num_wd_entries": int(wd_members.size),
        "max_level": int(level.max()) if g.n else 0,
        "avg_wd": float(sizes.mean()) if g.n else 0.0,
    }
    return IIndex(
        n=g.n,
        pid=pid,
        wd_members=wd_members,
        wd_offsets=wd_offsets,
        level=level,
        topo_order=order,
        stats=stats,
    )

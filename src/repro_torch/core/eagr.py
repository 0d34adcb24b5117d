"""EAGR baseline (Mondal & Deshpande, SIGMOD'14) — paper §2 / §6.2.

Faithful-in-structure reimplementation of the comparison system:

* the *overlay* is a bipartite mapping ``owner -> item list`` where items are
  vertex ids or virtual-node ids; initially ``overlay[v] = W(v)`` for every
  vertex (all windows materialized in memory — the paper's central criticism
  of EAGR's memory profile, which we reproduce deliberately);
* each iteration (i) sorts owners by their item lists lexicographically,
  (ii) splits them into equal-sized chunks, (iii) builds an FP-tree per chunk
  and mines frequent itemsets (bi-cliques of the bipartite overlay),
  (iv) materializes the best bi-cliques as virtual nodes and rewrites the
  owner lists through them;
* query evaluation resolves virtual nodes bottom-up (they form a DAG), then
  combines per owner.

The FP-growth miner is bounded (top patterns by saved-edge benefit) exactly
because EAGR's own iterations are bounded (10 in the paper's experiments).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.aggregates import AGGREGATES
from repro_torch.core.graph import Graph
from repro_torch.core.windows import (
    KHopWindow,
    TopologicalWindow,
    khop_windows,
    topological_windows,
)

Array = np.ndarray


# ------------------------------ FP-tree ------------------------------ #
class _FPNode:
    __slots__ = ("item", "count", "parent", "children")

    def __init__(self, item: int, parent: Optional["_FPNode"]):
        self.item = item
        self.count = 0
        self.parent = parent
        self.children: Dict[int, "_FPNode"] = {}


def _mine_chunk(itemsets: List[Array], min_support: int = 2,
                max_patterns: int = 64) -> List[Tuple[np.ndarray, List[int]]]:
    """Mine (itemset, supporting-owner-indices) bicliques from a chunk.

    Single-level FP-tree walk: insert transactions in frequency order, then
    read off maximal root-paths with count >= min_support.  Bounded, greedy,
    benefit-ordered — mirrors EAGR's VNM heuristic without unbounded
    recursion.
    """
    # item frequencies
    freq: Dict[int, int] = {}
    for t in itemsets:
        for it in t.tolist():
            freq[it] = freq.get(it, 0) + 1
    keep = {it for it, c in freq.items() if c >= min_support}
    if not keep:
        return []
    root = _FPNode(-1, None)
    owner_paths: List[Optional[_FPNode]] = []
    for t in itemsets:
        items = [it for it in t.tolist() if it in keep]
        items.sort(key=lambda it: (-freq[it], it))
        node = root
        for it in items:
            nxt = node.children.get(it)
            if nxt is None:
                nxt = _FPNode(it, node)
                node.children[it] = nxt
            nxt.count += 1
            node = nxt
        owner_paths.append(node if node is not root else None)
    # collect candidate paths: walk tree, emit (path_items, count) for nodes
    # with count >= min_support and depth >= 2
    cands: List[Tuple[int, _FPNode, int]] = []  # (benefit, node, depth)
    stack: List[Tuple[_FPNode, int]] = [(c, 1) for c in root.children.values()]
    while stack:
        node, depth = stack.pop()
        if node.count >= min_support and depth >= 2:
            benefit = node.count * depth - (node.count + depth)
            if benefit > 0:
                cands.append((benefit, node, depth))
        for ch in node.children.values():
            stack.append((ch, depth + 1))
    cands.sort(key=lambda x: -x[0])
    out: List[Tuple[np.ndarray, List[int]]] = []
    used_nodes: set = set()
    for benefit, node, depth in cands[: max_patterns * 4]:
        if len(out) >= max_patterns:
            break
        # path to root
        path = []
        cur: Optional[_FPNode] = node
        ok = True
        while cur is not None and cur.item != -1:
            if id(cur) in used_nodes:
                ok = False  # ancestor/descendant already consumed
                break
            path.append(cur.item)
            cur = cur.parent
        if not ok:
            continue
        # supporting owners: owners whose path passes through `node`
        supp = []
        for oi, leaf in enumerate(owner_paths):
            cur = leaf
            while cur is not None and cur.item != -1:
                if cur is node:
                    supp.append(oi)
                    break
                cur = cur.parent
        if len(supp) >= min_support:
            cur = node
            while cur is not None and cur.item != -1:
                used_nodes.add(id(cur))
                cur = cur.parent
            out.append((np.array(sorted(path), dtype=np.int64), supp))
    return out


# ------------------------------ overlay ------------------------------ #
@dataclasses.dataclass
class EAGRIndex:
    n: int
    overlay: List[Array]  # owner -> item list (items >= n are virtual)
    virtual_members: List[Array]  # virtual id - n -> member items
    stats: Dict = dataclasses.field(default_factory=dict)

    def size_bytes(self) -> int:
        s = sum(o.nbytes for o in self.overlay)
        s += sum(v.nbytes for v in self.virtual_members)
        return int(s)

    def query(self, values: Array, agg: str = "sum") -> Array:
        a = AGGREGATES[agg]
        chans = a.prepare(np.asarray(values))
        outs = []
        for monoid, chan in zip(a.monoids, chans):
            ident = monoid.identity_for(chan.dtype)  # dtype-safe (no upcast)
            vvals = np.full(len(self.virtual_members), ident, dtype=chan.dtype)
            # virtual nodes were appended in creation order: later virtuals
            # may reference earlier ones only -> evaluate in order
            for i, members in enumerate(self.virtual_members):
                base = members[members < self.n]
                virt = members[members >= self.n] - self.n
                acc = ident
                if base.size:
                    acc = monoid.np_op(acc, monoid.np_op.reduce(chan[base]))
                if virt.size:
                    acc = monoid.np_op(acc, monoid.np_op.reduce(vvals[virt]))
                vvals[i] = acc
            ans = np.full(self.n, ident, dtype=chan.dtype)
            for v in range(self.n):
                items = self.overlay[v]
                base = items[items < self.n]
                virt = items[items >= self.n] - self.n
                acc = ident
                if base.size:
                    acc = monoid.np_op(acc, monoid.np_op.reduce(chan[base]))
                if virt.size:
                    acc = monoid.np_op(acc, monoid.np_op.reduce(vvals[virt]))
                ans[v] = acc
            outs.append(ans)
        return a.finalize_np(*outs)


def build_eagr(
    g: Graph,
    window,
    iterations: int = 10,
    chunk_size: int = 256,
    memory_limit_bytes: Optional[int] = None,
) -> EAGRIndex:
    """Build the EAGR overlay.  Raises MemoryError if materializing all
    windows exceeds `memory_limit_bytes` (reproducing the paper's OOM runs).
    """
    t0 = time.perf_counter()
    if isinstance(window, KHopWindow):
        wins = khop_windows(g, window.k)
    elif isinstance(window, TopologicalWindow):
        wins = topological_windows(g)
    else:
        raise TypeError(window)
    footprint = sum(w.nbytes for w in wins)
    if memory_limit_bytes is not None and footprint > memory_limit_bytes:
        raise MemoryError(
            f"EAGR vertex-window mapping is {footprint/2**20:.1f} MiB "
            f"> limit {memory_limit_bytes/2**20:.1f} MiB"
        )
    overlay: List[Array] = [w.astype(np.int64) for w in wins]
    virtual_members: List[Array] = []
    n = g.n
    t_mine = 0.0
    for _ in range(iterations):
        order = sorted(range(n), key=lambda v: overlay[v].tolist())
        changed = False
        t1 = time.perf_counter()
        for clo in range(0, n, chunk_size):
            chunk_owner_ids = order[clo : clo + chunk_size]
            chunk_sets = [overlay[v] for v in chunk_owner_ids]
            for itemset, supp in _mine_chunk(chunk_sets):
                vid = n + len(virtual_members)
                virtual_members.append(itemset)
                iset = set(itemset.tolist())
                for oi in supp:
                    v = chunk_owner_ids[oi]
                    rest = np.array(
                        [it for it in overlay[v].tolist() if it not in iset],
                        dtype=np.int64,
                    )
                    overlay[v] = np.sort(np.append(rest, vid))
                changed = True
        t_mine += time.perf_counter() - t1
        if not changed:
            break
    return EAGRIndex(
        n=n,
        overlay=overlay,
        virtual_members=virtual_members,
        stats={
            "t_total_s": time.perf_counter() - t0,
            "t_mine_s": t_mine,
            "num_virtual": len(virtual_members),
            "window_footprint_bytes": footprint,
        },
    )

"""Window specifications, the window expression algebra, and host evaluation.

Implements the paper's two window instantiations (Definitions 1 and 2):

* :class:`KHopWindow` — ``W_kh(v)`` = vertices reachable from ``v`` within
  ``k`` hops (follows out-edges on directed graphs, all edges on undirected
  graphs).  Includes ``v`` itself, matching the paper's running examples
  (``W(B) = {A, B, D, F}`` contains ``B``).
* :class:`TopologicalWindow` — ``W_t(v)`` = ``{v}`` plus all ancestors of
  ``v`` in a DAG (the paper's example ``W_t(E) = {A,B,C,D,E}`` includes
  ``E``).

The paper notes DBIndex is agnostic to *how* per-vertex windows are defined
— dense-block sharing works for any window sets — so the two instantiations
are merely the **leaves** of an open :class:`WindowExpr` algebra:

* leaves :class:`KHop` (direction-aware k-hop ball) and :class:`Topo`;
* combinators :class:`Union`, :class:`Intersect`, :class:`Diff` (per-vertex
  set operations on the member sets);
* :class:`Filter` — mask window members by a boolean vertex attribute.

All expressions are hashable value objects; :func:`canonicalize` flattens
nested combinators, sorts commutative children, dedups, and applies
containment rewrites (``KHop(1) ⊆ KHop(2)`` so their union IS ``KHop(2)``
— reuse the larger materialization).  Evaluation rides the same packed
bitset machinery the leaves use: a combinator is one vectorized bitwise
op over the children's reachability matrices (:func:`expr_reach_bitsets`),
so the *existing* DBIndex builder/plan pipeline consumes composite windows
unchanged.

Host computation uses *batched multi-source bitset BFS*: reachability bits
for a batch of B source vertices are packed into ``uint64`` words and the
k-hop expansion is one vectorized scatter-OR per hop (``R[dst] |= R[src]``
grouped with ``np.bitwise_or.reduceat``).  This is the NumPy mirror of the
`bitset_expand` kernel and is what lets index construction avoid
materializing all windows at once (the paper's central memory argument
against EAGR).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.graph import Graph

Array = np.ndarray


# ---------------------------------------------------------------------- #
#  Window expression algebra
# ---------------------------------------------------------------------- #
class WindowExpr:
    """Base class of all window expressions (leaves and combinators).

    Subclasses are frozen dataclasses — hashable value objects usable as
    dict keys (plan groups, session states).  ``_key()`` returns a nested
    tuple that totally orders expressions for canonical child sorting.
    """

    def name(self) -> str:
        raise NotImplementedError

    def _key(self) -> tuple:
        raise NotImplementedError


# ---------------------------------------------------------------------- #
#  Window specs (canonical leaves)
# ---------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class KHopWindow(WindowExpr):
    """k-hop window (Definition 1)."""

    k: int

    def __post_init__(self):
        assert self.k >= 1

    def name(self) -> str:
        return f"khop[{self.k}]"

    def _key(self) -> tuple:
        return ("khop", self.k, "out")

    def windows(self, g: Graph, sources: Optional[Array] = None) -> List[Array]:
        return khop_windows(g, self.k, sources)

    def batches(self, g: Graph, batch: int = 4096) -> Iterator[Tuple[Array, List[Array]]]:
        return khop_window_batches(g, self.k, batch)


@dataclasses.dataclass(frozen=True)
class TopologicalWindow(WindowExpr):
    """Topological window (Definition 2) — ancestors in a DAG, plus self."""

    def name(self) -> str:
        return "topological"

    def _key(self) -> tuple:
        return ("topological",)

    def windows(self, g: Graph, sources: Optional[Array] = None) -> List[Array]:
        return topological_windows(g, sources)


@dataclasses.dataclass(frozen=True)
class KHop(WindowExpr):
    """Direction-aware k-hop leaf.

    ``direction="out"`` is Definition 1 (canonicalizes to
    :class:`KHopWindow`); ``"in"`` follows reverse edges (the k-hop
    *audience* of a vertex); ``"both"`` ignores orientation.  On undirected
    graphs all three coincide (the CSR caches are symmetrized), but
    canonicalization is graph-independent so only ``"out"`` is rewritten.
    """

    k: int
    direction: str = "out"

    def __post_init__(self):
        assert self.k >= 1
        assert self.direction in ("out", "in", "both"), self.direction

    def name(self) -> str:
        return f"khop[{self.k},{self.direction}]"

    def _key(self) -> tuple:
        return ("khop", self.k, self.direction)


@dataclasses.dataclass(frozen=True)
class Topo(WindowExpr):
    """Spelling alias of :class:`TopologicalWindow` (canonicalizes to it)."""

    def name(self) -> str:
        return "topological"

    def _key(self) -> tuple:
        return ("topological",)


@dataclasses.dataclass(frozen=True, init=False)
class Union(WindowExpr):
    """W(v) = union of the children's windows of ``v`` (commutative)."""

    exprs: Tuple[WindowExpr, ...]

    def __init__(self, *exprs):
        assert exprs, "Union needs at least one child window"
        object.__setattr__(self, "exprs", tuple(exprs))

    def name(self) -> str:
        return "union(" + ",".join(e.name() for e in self.exprs) + ")"

    def _key(self) -> tuple:
        return ("union",) + tuple(e._key() for e in self.exprs)


@dataclasses.dataclass(frozen=True, init=False)
class Intersect(WindowExpr):
    """W(v) = intersection of the children's windows of ``v`` (commutative)."""

    exprs: Tuple[WindowExpr, ...]

    def __init__(self, *exprs):
        assert exprs, "Intersect needs at least one child window"
        object.__setattr__(self, "exprs", tuple(exprs))

    def name(self) -> str:
        return "intersect(" + ",".join(e.name() for e in self.exprs) + ")"

    def _key(self) -> tuple:
        return ("intersect",) + tuple(e._key() for e in self.exprs)


@dataclasses.dataclass(frozen=True)
class Diff(WindowExpr):
    """W(v) = a's window of ``v`` minus b's window of ``v``."""

    a: WindowExpr
    b: WindowExpr

    def name(self) -> str:
        return f"diff({self.a.name()},{self.b.name()})"

    def _key(self) -> tuple:
        return ("diff", self.a._key(), self.b._key())


@dataclasses.dataclass(frozen=True)
class Filter(WindowExpr):
    """W(v) = members u of the child's window with ``attrs[pred][u]`` truthy.

    The predicate is a *vertex attribute name*: membership depends on
    attribute values, so attribute edits to ``predicate_attr`` are
    structural for the windows (the maintenance path rebuilds the affected
    state — see ``Session.update``).
    """

    expr: WindowExpr
    predicate_attr: str

    def name(self) -> str:
        return f"filter({self.expr.name()},{self.predicate_attr})"

    def _key(self) -> tuple:
        return ("filter", self.expr._key(), self.predicate_attr)


def is_leaf(expr) -> bool:
    """True for the materialization primitives (no child expressions)."""
    return isinstance(expr, (KHopWindow, TopologicalWindow, KHop, Topo))


def window_kind_of(window) -> str:
    """Capability kind: "khop" / "topological" for the paper leaves,
    "composite" for combinators and direction-variant k-hop leaves."""
    if isinstance(window, KHopWindow):
        return "khop"
    if isinstance(window, (TopologicalWindow, Topo)):
        return "topological"
    if isinstance(window, KHop):
        return "khop" if window.direction == "out" else "composite"
    if isinstance(window, WindowExpr):
        return "composite"
    raise TypeError(window)


def contains(a, b) -> bool:
    """Provable ``b ⊆ a`` (conservative: False means "unknown").

    Drives the canonicalization containment rewrites: a union drops every
    child some sibling provably contains (reuse the larger materialization),
    an intersection drops every child that provably contains a sibling.
    """
    if a == b:
        return True
    ka, kb = a._key(), b._key()
    if ka[0] == kb[0] == "khop" and ka[2] == kb[2]:
        return kb[1] <= ka[1]
    if isinstance(a, Union) and any(contains(c, b) for c in a.exprs):
        return True
    if isinstance(b, Intersect) and any(contains(a, c) for c in b.exprs):
        return True
    if isinstance(b, Filter) and contains(a, b.expr):
        return True
    return False


def canonicalize(expr):
    """Canonical form: flatten, sort + dedup commutative children, rewrite
    containment, normalize leaf spellings.  Equal queries — e.g.
    ``Union(A, B)`` and ``Union(B, A)`` — canonicalize to one value object
    and therefore hit one cached plan."""
    if isinstance(expr, (KHopWindow, TopologicalWindow)):
        return expr
    if isinstance(expr, KHop):
        return KHopWindow(expr.k) if expr.direction == "out" else expr
    if isinstance(expr, Topo):
        return TopologicalWindow()
    if isinstance(expr, (Union, Intersect)):
        cls = type(expr)
        flat: List[WindowExpr] = []
        for c in expr.exprs:
            c = canonicalize(c)
            flat.extend(c.exprs if isinstance(c, cls) else [c])
        flat = sorted(set(flat), key=lambda e: e._key())
        kept = _drop_contained(flat, larger_wins=cls is Union)
        if len(kept) == 1:
            return kept[0]
        return cls(*kept)
    if isinstance(expr, Diff):
        return Diff(canonicalize(expr.a), canonicalize(expr.b))
    if isinstance(expr, Filter):
        child = canonicalize(expr.expr)
        if isinstance(child, Filter) and child.predicate_attr == expr.predicate_attr:
            return child
        return Filter(child, expr.predicate_attr)
    raise TypeError(f"not a window expression: {expr!r}")


def _drop_contained(exprs: Sequence[WindowExpr], larger_wins: bool) -> List[WindowExpr]:
    """Containment filter for deduped commutative children: a union keeps
    the larger of a provably nested pair, an intersection the smaller."""
    out: List[WindowExpr] = []
    for c in exprs:
        if larger_wins:
            redundant = any(o != c and contains(o, c) for o in exprs)
        else:
            redundant = any(o != c and contains(c, o) for o in exprs)
        if not redundant:
            out.append(c)
    return out


def expr_leaves(expr) -> List[WindowExpr]:
    """All leaf windows of an expression, in evaluation order."""
    if is_leaf(expr):
        return [expr]
    if isinstance(expr, (Union, Intersect)):
        return [l for c in expr.exprs for l in expr_leaves(c)]
    if isinstance(expr, Diff):
        return expr_leaves(expr.a) + expr_leaves(expr.b)
    if isinstance(expr, Filter):
        return expr_leaves(expr.expr)
    raise TypeError(expr)


def filter_attrs(expr) -> frozenset:
    """Attribute names any :class:`Filter` in the expression predicates on
    (edits to them change window *membership*, not just values)."""
    if is_leaf(expr):
        return frozenset()
    if isinstance(expr, Filter):
        return frozenset({expr.predicate_attr}) | filter_attrs(expr.expr)
    if isinstance(expr, (Union, Intersect)):
        out = frozenset()
        for c in expr.exprs:
            out |= filter_attrs(c)
        return out
    if isinstance(expr, Diff):
        return filter_attrs(expr.a) | filter_attrs(expr.b)
    raise TypeError(expr)


WindowSpec = object  # typing alias; any WindowExpr


# ---------------------------------------------------------------------- #
#  Batched bitset BFS
# ---------------------------------------------------------------------- #
def _scatter_or_rows(
    reach: Array, src_sorted: Array, dst_sorted: Array, group_starts: Array, dst_unique: Array
) -> Array:
    """new[dst] |= OR-reduce of reach[src] grouped by dst.  reach: [n, W] u64."""
    if src_sorted.size == 0:
        return reach
    gathered = reach[src_sorted]  # [E, W]
    reduced = np.bitwise_or.reduceat(gathered, group_starts, axis=0)
    out = reach.copy()
    out[dst_unique] |= reduced
    return out


def _sorted_edges_by_dst(g: Graph) -> Tuple[Array, Array, Array, Array]:
    """Symmetrized-if-undirected edges sorted by dst + reduceat group info."""
    if g.directed:
        src, dst = g.src, g.dst
    else:
        src = np.concatenate([g.src, g.dst])
        dst = np.concatenate([g.dst, g.src])
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    dst_unique, group_starts = np.unique(dst, return_index=True)
    return src, dst, group_starts, dst_unique


def khop_reach_bitsets(g: Graph, k: int, sources: Array) -> Array:
    """Packed reachability: bit j of word row u says source[j] reaches u in <=k hops.

    Returns uint64 array of shape [n, ceil(B/64)].
    """
    sources = np.asarray(sources, np.int64)
    b = sources.size
    words = (b + 63) // 64
    reach = np.zeros((g.n, words), dtype=np.uint64)
    cols = np.arange(b)
    reach[sources, cols // 64] |= np.uint64(1) << (cols % 64).astype(np.uint64)
    src, dst, group_starts, dst_unique = _sorted_edges_by_dst(g)
    for _ in range(k):
        new = _scatter_or_rows(reach, src, dst, group_starts, dst_unique)
        if np.array_equal(new, reach):  # converged early (small diameter)
            break
        reach = new
    return reach


def _bitsets_to_windows(reach: Array, sources: Array) -> List[Array]:
    """Column j of the packed matrix -> sorted member array for source j."""
    n, _ = reach.shape
    b = sources.size
    out: List[Array] = []
    # unpack per 64-column block to bound memory
    for w in range((b + 63) // 64):
        lo, hi = w * 64, min((w + 1) * 64, b)
        block = reach[:, w]  # [n] uint64
        for j in range(lo, hi):
            bit = np.uint64(1) << np.uint64(j - lo)
            members = np.flatnonzero((block & bit) != 0).astype(np.int32)
            out.append(members)
    return out


def khop_windows(g: Graph, k: int, sources: Optional[Array] = None) -> List[Array]:
    """Materialize W_kh for the given sources (default: all vertices)."""
    if sources is None:
        sources = np.arange(g.n, dtype=np.int32)
    sources = np.asarray(sources, np.int32)
    out: List[Array] = []
    for lo in range(0, sources.size, 4096):
        batch = sources[lo : lo + 4096]
        reach = khop_reach_bitsets(g, k, batch)
        out.extend(_bitsets_to_windows(reach, batch))
    return out


def khop_window_batches(
    g: Graph, k: int, batch: int = 4096
) -> Iterator[Tuple[Array, List[Array]]]:
    """Stream (source_batch, windows) without holding all windows in memory."""
    sources = np.arange(g.n, dtype=np.int32)
    for lo in range(0, g.n, batch):
        chunk = sources[lo : lo + batch]
        reach = khop_reach_bitsets(g, k, chunk)
        yield chunk, _bitsets_to_windows(reach, chunk)


def khop_window_single(g: Graph, k: int, v: int) -> Array:
    """Per-vertex frontier BFS — the paper's Non-Indexed primitive."""
    seen = np.zeros(g.n, dtype=bool)
    seen[v] = True
    frontier = np.array([v], dtype=np.int32)
    for _ in range(k):
        if frontier.size == 0:
            break
        starts = g.out_indptr[frontier]
        lens = g.out_indptr[frontier + 1] - starts
        total = int(lens.sum())
        if total == 0:
            break
        idx = np.repeat(starts, lens) + (
            np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens)
        )
        nbr = g.out_indices[idx]
        nbr = nbr[~seen[nbr]]
        nbr = np.unique(nbr)
        seen[nbr] = True
        frontier = nbr.astype(np.int32)
    return np.flatnonzero(seen).astype(np.int32)


# ---------------------------------------------------------------------- #
#  Topological windows (ancestor sets)
# ---------------------------------------------------------------------- #
def topological_windows(g: Graph, sources: Optional[Array] = None) -> List[Array]:
    """W_t(v) = {v} ∪ ancestors(v) for every v (or the given sources).

    One topological sweep propagating packed ancestor bitsets down out-edges.
    Memory is bounded by freeing a vertex's bitset once all children consumed
    it (the paper's Algorithm 4 memory discipline); here we keep the simple
    dense [n, n/64] variant for n up to ~60k and a chunked variant above.
    """
    order = g.topological_order()
    words = (g.n + 63) // 64
    # chunk over *bit columns* (ancestor id space) to bound memory at ~512MB
    max_cols_words = max(1, (512 * 2**20) // max(1, 8 * g.n))
    anc = None
    pieces: List[Array] = []
    for wlo in range(0, words, max_cols_words):
        whi = min(words, wlo + max_cols_words)
        anc = np.zeros((g.n, whi - wlo), dtype=np.uint64)
        ids = np.arange(g.n, dtype=np.int64)
        in_range = (ids >= wlo * 64) & (ids < whi * 64)
        rel = ids[in_range] - wlo * 64
        anc[ids[in_range], rel // 64] |= np.uint64(1) << (rel % 64).astype(np.uint64)
        for v in order:
            ch = g.out_neighbors(v)
            if ch.size:
                anc[ch] |= anc[v]
        pieces.append(anc)
    full = np.concatenate(pieces, axis=1) if len(pieces) > 1 else pieces[0]
    if sources is None:
        sources = np.arange(g.n, dtype=np.int32)
    out: List[Array] = []
    for v in np.asarray(sources, np.int64):
        row = full[v]
        members = np.flatnonzero(
            np.unpackbits(row.view(np.uint8), bitorder="little")[: g.n]
        ).astype(np.int32)
        out.append(members)
    return out


def descendants_multi(g: Graph, seeds: Array) -> Array:
    """Seeds plus everything reachable from any seed (directed, forward).

    One vectorized multi-source BFS (frontier gathers via
    ``Graph._frontier_out``) — this is the batched replacement for calling
    :func:`repro_torch.core.updates.descendants` once per edge.
    """
    seen = np.zeros(g.n, dtype=bool)
    seeds = np.unique(np.asarray(seeds, np.int64))
    seen[seeds] = True
    frontier = seeds.astype(np.int32)
    while frontier.size:
        nbr = g._frontier_out(frontier)
        if nbr.size == 0:
            break
        nbr = np.unique(nbr[~seen[nbr]])
        seen[nbr] = True
        frontier = nbr.astype(np.int32)
    return np.flatnonzero(seen).astype(np.int32)


def topological_window_single(g: Graph, v: int) -> Array:
    """Reverse BFS from v over in-edges (brute-force oracle)."""
    seen = np.zeros(g.n, dtype=bool)
    seen[v] = True
    frontier = [int(v)]
    while frontier:
        u = frontier.pop()
        for p in g.in_neighbors(u):
            if not seen[p]:
                seen[p] = True
                frontier.append(int(p))
    return np.flatnonzero(seen).astype(np.int32)


# ---------------------------------------------------------------------- #
#  Expression evaluation (packed bitsets — the generic lowering path)
# ---------------------------------------------------------------------- #
def graph_view(g: Graph, direction: str) -> Graph:
    """Directed graph reinterpreted for a leaf's traversal direction.

    ``"out"`` is the graph itself; ``"in"`` swaps edge orientation;
    ``"both"`` drops orientation.  Undirected graphs are returned as-is
    (their CSR caches are already symmetrized).  Views are memoized on the
    graph object (graphs are immutable — updates build new ones): callers
    sit in hot loops (per-vertex oracle BFS, per-chunk expression
    materialization, per-batch affected-owner maintenance) and must not
    pay the O(E log E) CSR rebuild on every call."""
    if not g.directed or direction == "out":
        return g
    if direction == "in":
        return g.reverse_view()  # O(1): swaps the existing CSR caches
    memo = getattr(g, "_dir_views", None)
    if memo is None:
        memo = {}
        object.__setattr__(g, "_dir_views", memo)
    if direction not in memo:
        # "both" genuinely needs the symmetrized CSR built once per graph
        memo[direction] = Graph(n=g.n, src=g.src, dst=g.dst, directed=False)
    return memo[direction]


def expr_reach_bitsets(g: Graph, expr, sources: Array) -> Array:
    """Packed membership matrix of a window expression: bit ``j`` of word
    row ``u`` says ``u ∈ W_expr(sources[j])``.  Combinators are single
    vectorized bitwise ops over the children's matrices — the same
    ``[n, ceil(B/64)]`` layout the leaf BFS produces, so the DBIndex
    builder's pair-extraction path consumes composite windows unchanged."""
    sources = np.asarray(sources, np.int32)
    if isinstance(expr, KHopWindow):
        return khop_reach_bitsets(g, expr.k, sources)
    if isinstance(expr, KHop):
        return khop_reach_bitsets(graph_view(g, expr.direction), expr.k, sources)
    if isinstance(expr, (TopologicalWindow, Topo)):
        # u ∈ W_t(v) iff u reaches v: one reverse multi-source BFS, run to
        # convergence (khop_reach_bitsets breaks on a fixed point)
        return khop_reach_bitsets(graph_view(g, "in"), max(g.n, 1), sources)
    if isinstance(expr, Union):
        out = expr_reach_bitsets(g, expr.exprs[0], sources)
        for c in expr.exprs[1:]:
            out = out | expr_reach_bitsets(g, c, sources)
        return out
    if isinstance(expr, Intersect):
        out = expr_reach_bitsets(g, expr.exprs[0], sources)
        for c in expr.exprs[1:]:
            out = out & expr_reach_bitsets(g, c, sources)
        return out
    if isinstance(expr, Diff):
        return expr_reach_bitsets(g, expr.a, sources) & ~expr_reach_bitsets(
            g, expr.b, sources)
    if isinstance(expr, Filter):
        out = expr_reach_bitsets(g, expr.expr, sources).copy()
        pred = np.asarray(g.attrs[expr.predicate_attr])
        out[pred == 0] = 0  # member rows failing the predicate drop out
        return out
    raise TypeError(f"not a window expression: {expr!r}")


def expr_windows(g: Graph, expr, sources: Optional[Array] = None,
                 batch: int = 4096) -> List[Array]:
    """Materialize W_expr for the given sources (default: all vertices)."""
    if sources is None:
        sources = np.arange(g.n, dtype=np.int32)
    sources = np.asarray(sources, np.int32)
    out: List[Array] = []
    for lo in range(0, sources.size, batch):
        chunk = sources[lo : lo + batch]
        reach = expr_reach_bitsets(g, expr, chunk)
        out.extend(_bitsets_to_windows(reach, chunk))
    return out


def expr_window_single(g: Graph, expr, v: int) -> Array:
    """Per-vertex set evaluation — the brute-force oracle path, kept
    independent of the bitset machinery (frontier BFS per leaf + NumPy set
    ops per combinator)."""
    if isinstance(expr, KHopWindow):
        return khop_window_single(g, expr.k, v)
    if isinstance(expr, KHop):
        return khop_window_single(graph_view(g, expr.direction), expr.k, v)
    if isinstance(expr, (TopologicalWindow, Topo)):
        return topological_window_single(g, v)
    if isinstance(expr, Union):
        out = expr_window_single(g, expr.exprs[0], v)
        for c in expr.exprs[1:]:
            out = np.union1d(out, expr_window_single(g, c, v))
        return out.astype(np.int32)
    if isinstance(expr, Intersect):
        out = expr_window_single(g, expr.exprs[0], v)
        for c in expr.exprs[1:]:
            out = np.intersect1d(out, expr_window_single(g, c, v))
        return out.astype(np.int32)
    if isinstance(expr, Diff):
        return np.setdiff1d(
            expr_window_single(g, expr.a, v), expr_window_single(g, expr.b, v)
        ).astype(np.int32)
    if isinstance(expr, Filter):
        members = expr_window_single(g, expr.expr, v)
        pred = np.asarray(g.attrs[expr.predicate_attr])
        return members[pred[members] != 0].astype(np.int32)
    raise TypeError(f"not a window expression: {expr!r}")


# ---------------------------------------------------------------------- #
#  Reverse membership (containing-owner) evaluation
# ---------------------------------------------------------------------- #
def _flip_direction(direction: str) -> str:
    return {"out": "in", "in": "out", "both": "both"}[direction]


def expr_containing_bitsets(
    g: Graph, expr, sources: Array,
    uncertain_attrs: frozenset = frozenset(), upper: bool = True,
) -> Array:
    """Packed *reverse* membership matrix: bit ``j`` of word row ``v`` says
    ``sources[j] ∈ W_expr(v)`` — the transpose question of
    :func:`expr_reach_bitsets`, answered without materializing any window.
    Leaves run the same multi-source bitset BFS with the traversal
    direction flipped (``u ∈ W_khop(v)`` iff ``u`` reaches ``v`` in the
    reversed view; ``u ∈ W_topo(v)`` iff ``u`` reaches ``v`` forward);
    combinators stay pointwise; a :class:`Filter` masks bit *columns*
    (the sources failing its predicate) instead of member rows.

    ``uncertain_attrs`` computes an *envelope* instead of the exact
    matrix: a Filter predicating on an uncertain attribute is treated as
    free to admit (``upper=True``) or reject (``upper=False``) every
    source.  ``Diff`` swaps the envelope side for its subtrahend, so the
    upper matrix is a sound superset of membership under ANY truth
    assignment of the uncertain predicates at the sources — which is what
    bounds the affected-owner set of a predicate-attribute edit (the
    sources being exactly the vertices whose truthiness flipped).
    """
    sources = np.asarray(sources, np.int32)
    if isinstance(expr, KHopWindow):
        return khop_reach_bitsets(graph_view(g, "in"), expr.k, sources)
    if isinstance(expr, KHop):
        view = graph_view(g, _flip_direction(expr.direction))
        return khop_reach_bitsets(view, expr.k, sources)
    if isinstance(expr, (TopologicalWindow, Topo)):
        # u ∈ W_t(v) iff u reaches v: forward BFS, run to convergence
        return khop_reach_bitsets(g, max(g.n, 1), sources)
    if isinstance(expr, Union):
        out = expr_containing_bitsets(g, expr.exprs[0], sources,
                                      uncertain_attrs, upper)
        for c in expr.exprs[1:]:
            out = out | expr_containing_bitsets(g, c, sources,
                                                uncertain_attrs, upper)
        return out
    if isinstance(expr, Intersect):
        out = expr_containing_bitsets(g, expr.exprs[0], sources,
                                      uncertain_attrs, upper)
        for c in expr.exprs[1:]:
            out = out & expr_containing_bitsets(g, c, sources,
                                                uncertain_attrs, upper)
        return out
    if isinstance(expr, Diff):
        # the subtrahend flips envelope side: possibly-in(a \ b) needs
        # definitely-in(b), and vice versa
        return expr_containing_bitsets(
            g, expr.a, sources, uncertain_attrs, upper
        ) & ~expr_containing_bitsets(
            g, expr.b, sources, uncertain_attrs, not upper)
    if isinstance(expr, Filter):
        child = expr_containing_bitsets(g, expr.expr, sources,
                                        uncertain_attrs, upper)
        if expr.predicate_attr in uncertain_attrs:
            if upper:
                return child  # predicate may admit every source
            return np.zeros_like(child)  # ... or reject every source
        pred = np.asarray(g.attrs[expr.predicate_attr])
        cols = np.flatnonzero(pred[sources.astype(np.int64)] != 0)
        mask = np.zeros((sources.size + 63) // 64, dtype=np.uint64)
        np.bitwise_or.at(  # duplicate word slots: plain |= keeps one bit
            mask, cols // 64, np.uint64(1) << (cols % 64).astype(np.uint64))
        return child & mask  # broadcasts over rows
    raise TypeError(f"not a window expression: {expr!r}")


def expr_containing_owners(
    g: Graph, expr, vertices: Array,
    uncertain_attrs: frozenset = frozenset(), batch: int = 4096,
) -> Array:
    """Owners ``v`` with ``W_expr(v) ∩ vertices ≠ ∅`` (with
    ``uncertain_attrs``: owners that could contain one under *some* truth
    assignment of those predicates at the vertices) — the index-free
    reverse window map.  Chunked like :func:`expr_windows`."""
    vertices = np.asarray(vertices, np.int64)
    if vertices.size == 0:
        return np.empty(0, np.int32)
    hit = np.zeros(g.n, dtype=bool)
    for lo in range(0, vertices.size, batch):
        m = expr_containing_bitsets(g, expr, vertices[lo: lo + batch],
                                    uncertain_attrs, upper=True)
        hit |= (m != 0).any(axis=1)
    return np.flatnonzero(hit).astype(np.int32)


def has_diff(expr) -> bool:
    """True when the expression contains a :class:`Diff` node (predicate
    flips can then *add* members through the subtrahend, so a pure-loss
    edit is not guaranteed to only shrink windows)."""
    if is_leaf(expr):
        return False
    if isinstance(expr, Diff):
        return True
    if isinstance(expr, (Union, Intersect)):
        return any(has_diff(c) for c in expr.exprs)
    if isinstance(expr, Filter):
        return has_diff(expr.expr)
    raise TypeError(expr)

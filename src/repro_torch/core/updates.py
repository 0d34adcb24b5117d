"""Dynamic-graph updates (paper §4.3 and §5.3), single-edge and streaming.

Attribute updates never touch either index (both are structure-only).

Structural updates come in two granularities:

* **Single edge** — :func:`insert_edge` / :func:`delete_edge` plus
  :func:`update_dbindex` / :func:`update_iindex`, kept as thin wrappers over
  the batched path below.
* **Batched streams** — :class:`UpdateBatch` (vectorized edge insert/delete
  sets, optionally timestamped) applied atomically with :func:`apply_batch`.
  :func:`update_dbindex_batch` / :func:`update_iindex_batch` compute the
  affected owner set / descendant cone for the *whole batch* with one
  multi-source bitset BFS instead of one traversal per edge, so maintenance
  cost is proportional to the touched region, not to the batch size times
  the graph.

DBIndex maintenance is the paper's two-phase scheme (§4.3): Phase 1 drops
the affected owners' links from the primary index, builds a *secondary*
index over their new windows, and merges — exactly correct but possibly
less shared than a fresh build.  Phase 2 (:func:`reorganize`) is the
periodic full rebuild; :mod:`repro_torch.core.streaming` decides *when* via a
sharing-loss staleness policy.

I-Index maintenance localizes §5.3's four cases to the descendant cone of
the touched edge heads: every vertex whose ancestor set may change is a
descendant of some head ``t``, so PID/WD/level are recomputed for exactly
that cone.  Cone windows are rebuilt by a cone-restricted topological
sweep whose out-of-cone parents are seeded from the *old* index's windows
(unchanged by definition of the cone) — maintenance never traverses the
graph outside the cone, and is depth-independent.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.dbindex import DBIndex, _Builder, _blocks_from_windows, build_dbindex
from repro_torch.core.graph import Graph
from repro_torch.core.iindex import IIndex, build_iindex
from repro_torch.core.windows import (
    KHop,
    KHopWindow,
    Topo,
    TopologicalWindow,
    WindowExpr,
    descendants_multi,
    expr_leaves,
    expr_windows,
    graph_view,
    khop_reach_bitsets,
    khop_windows,
)

Array = np.ndarray


# ---------------------------------------------------------------------- #
#  Update batches
# ---------------------------------------------------------------------- #
OP_INSERT = np.int8(1)
OP_DELETE = np.int8(-1)


@dataclasses.dataclass(frozen=True)
class AttrEdit:
    """One vectorized attribute-value edit: ``attrs[name][vertices] = values``.

    Attribute edits never touch window *membership* (both indices are
    structure-only) — except for :class:`~repro_torch.core.windows.Filter`
    predicates, which the Session maintenance path detects and rebuilds.
    What they do invalidate is cached *results*: exactly the owners whose
    windows contain an edited vertex (the DBIndex reverse link map).
    """

    name: str
    vertices: Array  # int64 [K]
    values: Array  # [K], cast to the attribute's dtype on apply

    def __post_init__(self):
        object.__setattr__(self, "vertices",
                           np.asarray(self.vertices, np.int64))
        object.__setattr__(self, "values", np.asarray(self.values))
        assert self.vertices.shape == self.values.shape


@dataclasses.dataclass(frozen=True)
class UpdateBatch:
    """A vectorized set of edge insertions/deletions, applied atomically.

    ``op[i]`` is +1 (insert) or -1 (delete).  ``ts`` is an optional
    per-edit timestamp used by stream replay (not by maintenance).
    Semantics of :func:`apply_batch`: deletions are resolved against the
    *pre-batch* edge list first, then insertions are appended, then
    ``attr_edits`` (vectorized attribute-value assignments) land on the
    new graph.  ``size`` counts structural edits only — an attr-only batch
    (``size == 0``) skips index/plan maintenance entirely.
    """

    src: Array  # int32 [B]
    dst: Array  # int32 [B]
    op: Array  # int8  [B]
    ts: Optional[Array] = None  # float64 [B] or None
    attr_edits: Tuple[AttrEdit, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "src", np.asarray(self.src, np.int32))
        object.__setattr__(self, "dst", np.asarray(self.dst, np.int32))
        object.__setattr__(self, "op", np.asarray(self.op, np.int8))
        assert self.src.shape == self.dst.shape == self.op.shape
        if self.ts is not None:
            object.__setattr__(self, "ts", np.asarray(self.ts, np.float64))
            assert self.ts.shape == self.src.shape
        object.__setattr__(self, "attr_edits", tuple(self.attr_edits))

    @property
    def size(self) -> int:
        return int(self.src.size)

    @property
    def attr_size(self) -> int:
        return int(sum(e.vertices.size for e in self.attr_edits))

    def edited_attrs(self) -> Tuple[str, ...]:
        return tuple(dict.fromkeys(e.name for e in self.attr_edits))

    @staticmethod
    def inserts(src: Sequence[int], dst: Sequence[int], ts=None) -> "UpdateBatch":
        src = np.asarray(src, np.int32)
        return UpdateBatch(src, np.asarray(dst, np.int32),
                           np.full(src.size, OP_INSERT), ts)

    @staticmethod
    def deletes(src: Sequence[int], dst: Sequence[int], ts=None) -> "UpdateBatch":
        src = np.asarray(src, np.int32)
        return UpdateBatch(src, np.asarray(dst, np.int32),
                           np.full(src.size, OP_DELETE), ts)

    @staticmethod
    def attr_set(name: str, vertices: Sequence[int], values) -> "UpdateBatch":
        """An attribute-only batch: no structural edits, one value edit."""
        empty = np.empty(0, np.int32)
        return UpdateBatch(empty, empty, np.empty(0, np.int8),
                           attr_edits=(AttrEdit(name, vertices, values),))

    def to_bytes(self) -> bytes:
        """Deterministic byte encoding (WAL record / replication payload)."""
        return encode_update_batch(self)

    @staticmethod
    def from_bytes(data: bytes) -> "UpdateBatch":
        return decode_update_batch(data)

    @staticmethod
    def concat(batches: Sequence["UpdateBatch"]) -> "UpdateBatch":
        ts = None
        if batches and all(b.ts is not None for b in batches):
            ts = np.concatenate([b.ts for b in batches])
        return UpdateBatch(
            np.concatenate([b.src for b in batches]) if batches else np.empty(0, np.int32),
            np.concatenate([b.dst for b in batches]) if batches else np.empty(0, np.int32),
            np.concatenate([b.op for b in batches]) if batches else np.empty(0, np.int8),
            ts,
            tuple(e for b in batches for e in b.attr_edits),
        )


def apply_batch(g: Graph, batch: UpdateBatch) -> Graph:
    """Apply a whole batch in O(E + B log B): vectorized key-matched
    deletions (first occurrence per requested multiplicity) + appended
    insertions + attribute-value edits.  Raises KeyError if a deletion has
    no matching edge."""
    g = _apply_structural(g, batch)
    for e in batch.attr_edits:
        arr = np.array(g.attrs[e.name])  # copy: graphs are immutable
        arr[e.vertices] = e.values.astype(arr.dtype)
        g = g.with_attr(e.name, arr)
    return g


def _apply_structural(g: Graph, batch: UpdateBatch) -> Graph:
    if batch.size == 0:
        return g
    ins = batch.op > 0
    dels = batch.op < 0
    new_src, new_dst = g.src, g.dst
    if dels.any():
        del_keys = g.edge_keys(batch.src[dels], batch.dst[dels])
        uk, req = np.unique(del_keys, return_counts=True)
        keys = g.edge_keys()
        order = np.argsort(keys, kind="stable")
        sk = keys[order]
        lo = np.searchsorted(sk, uk, "left")
        hi = np.searchsorted(sk, uk, "right")
        avail = hi - lo
        if (avail < req).any():
            missing = uk[avail < req]
            raise KeyError(
                f"{missing.size} deleted edge(s) not present "
                f"(first key {int(missing[0])})"
            )
        # occurrence rank of every edge within its key group
        grp_starts = np.flatnonzero(np.diff(sk, prepend=np.int64(-1)) != 0)
        grp_len = np.diff(np.append(grp_starts, sk.size))
        rank = np.empty(g.n_edges, np.int64)
        rank[order] = np.arange(g.n_edges) - np.repeat(grp_starts, grp_len)
        pos = np.searchsorted(uk, keys)
        pos_c = np.clip(pos, 0, uk.size - 1)
        matched = (pos < uk.size) & (uk[pos_c] == keys)
        remove = matched & (rank < req[pos_c])
        keep = ~remove
        new_src, new_dst = new_src[keep], new_dst[keep]
    if ins.any():
        new_src = np.append(new_src, batch.src[ins])
        new_dst = np.append(new_dst, batch.dst[ins])
    return g.with_edges(new_src, new_dst)


# --------------------------- graph edits ------------------------------ #
def insert_edge(g: Graph, s: int, t: int) -> Graph:
    return g.with_edges(np.append(g.src, np.int32(s)), np.append(g.dst, np.int32(t)))


def delete_edge(g: Graph, s: int, t: int) -> Graph:
    hit = np.flatnonzero((g.src == s) & (g.dst == t))
    if not g.directed and hit.size == 0:
        hit = np.flatnonzero((g.src == t) & (g.dst == s))
    if hit.size == 0:
        raise KeyError(f"edge ({s},{t}) not present")
    keep = np.ones(g.n_edges, dtype=bool)
    keep[hit[0]] = False
    return g.with_edges(g.src[keep], g.dst[keep])


# ------------------------ affected-owner sets ------------------------- #
# Above this many seed endpoints the multi-source BFS routes through the
# ``bitset_expand`` kernel K2 (one device hop expands 4096 sources at
# once); below it the NumPy scatter-OR wins because the per-call tile-plan
# build dominates.  Tests force either path via ``use_device``.
DEVICE_BFS_MIN_SEEDS = 4096


def _reverse_expand_plan(g_rev: Graph, torch_device="cuda"):
    """The ``bitset_expand`` plan of ``g_rev``'s edges (symmetrized when
    undirected, like the host bitset BFS), sorted by destination, laid out
    on the host and uploaded to ``torch_device``."""
    from repro_torch.kernels.bitset_expand.ops import build_expand_plan

    if g_rev.directed:
        src, dst = g_rev.src, g_rev.dst
    else:
        src = np.concatenate([g_rev.src, g_rev.dst])
        dst = np.concatenate([g_rev.dst, g_rev.src])
    order = np.argsort(dst, kind="stable")
    return build_expand_plan(src[order], dst[order], g_rev.n,
                             torch_device=torch_device)


def _device_khop_reach_any(g_rev: Graph, k: int, seeds: Array,
                           torch_device="cuda") -> Array:
    """Device mirror of the reverse multi-source BFS: one ``bitset_expand``
    tile plan over the reverse edges, then k expansion hops (K2 launches)
    per 4096-seed chunk, each handing its occupancy mask to the next.
    Returns the bool [n] mask of vertices reaching any seed: a row is
    reached iff its final mask is nonzero, so only the masks come back to
    the host."""
    from repro_torch.kernels.bitset_expand.ops import khop_reach_masked

    plan = _reverse_expand_plan(g_rev, torch_device)
    mask = np.zeros(g_rev.n, dtype=bool)
    for lo in range(0, seeds.size, 4096):
        _, occ = khop_reach_masked(plan, g_rev.n, seeds[lo : lo + 4096], k)
        mask |= (occ != 0).any(dim=1).cpu().numpy()
    return mask


def affected_owners_khop_multi(
    g_new: Graph, k: int, seeds: Array, use_device: Optional[bool] = None,
    torch_device="cuda",
) -> Array:
    """Owners whose k-hop window may change after a batch touching edges
    with the given seed endpoints: every vertex that reaches *any* seed
    within k-1 hops (plus the seeds).  One multi-source reverse bitset BFS
    for the whole batch — on host NumPy for small batches, through the
    ``bitset_expand`` kernel on ``torch_device`` above
    :data:`DEVICE_BFS_MIN_SEEDS` (``use_device`` pins either path)."""
    seeds = np.unique(np.asarray(seeds, np.int64))
    if seeds.size == 0:
        return np.empty(0, np.int32)
    rg = g_new.reverse_view()  # O(1) CSR-cache swap (self when undirected)
    if use_device is None:  # auto-routing: device pays off past the
        # threshold, and only when there is at least one hop to expand
        use_device = seeds.size >= DEVICE_BFS_MIN_SEEDS and k > 1
    if use_device:  # an explicit pin is honored even for k == 1
        mask = _device_khop_reach_any(rg, max(k - 1, 0), seeds, torch_device)
        mask[seeds] = True
        return np.flatnonzero(mask).astype(np.int32)
    out = [seeds]
    for lo in range(0, seeds.size, 4096):
        chunk = seeds[lo : lo + 4096].astype(np.int32)
        reach = khop_reach_bitsets(rg, max(k - 1, 0), chunk)
        out.append(np.flatnonzero((reach != 0).any(axis=1)))
    return np.unique(np.concatenate(out)).astype(np.int32)


def _leaf_affected(g_new: Graph, leaf, batch: UpdateBatch,
                   use_device: Optional[bool], torch_device="cuda") -> Array:
    """Affected owners of one *leaf* window for a structural batch."""
    if isinstance(leaf, KHopWindow):
        return affected_owners_khop_multi(
            g_new, leaf.k, _khop_seeds(g_new, batch), use_device=use_device,
            torch_device=torch_device,
        )
    if isinstance(leaf, KHop):
        view = graph_view(g_new, leaf.direction)
        if leaf.direction == "in" and g_new.directed:
            # W_in(v) = {u : u →≤k v}: an edit on (s, t) reaches v's window
            # only through t, so the affected set is the forward (k-1)-ball
            # of the heads — which IS the reverse ball in the flipped view
            seeds = batch.dst.astype(np.int64)
        else:
            seeds = _khop_seeds(view, batch)
        return affected_owners_khop_multi(view, leaf.k, seeds,
                                          use_device=use_device,
                                          torch_device=torch_device)
    if isinstance(leaf, (TopologicalWindow, Topo)):
        return descendants_multi(g_new, batch.dst.astype(np.int64))
    raise TypeError(leaf)


def affected_owners(
    g_new: Graph, window, batch: UpdateBatch,
    use_device: Optional[bool] = None, torch_device="cuda",
) -> Array:
    """Affected-owner set of one batch for any window expression — the
    exact set whose windows the batched maintenance recomputes, and
    therefore the exact invalidation set for any cached per-vertex results
    (everything outside it provably keeps its window, so a serving-layer
    cache entry for it stays valid across the batch).

    K-hop windows: every vertex reaching a touched endpoint within k-1
    hops (plus the endpoints); topological windows: the descendant cone of
    the touched edge heads.  Composite windows inherit the property from
    their leaves: set operations are pointwise on per-vertex member sets,
    so a composite window of ``v`` can only change if some leaf window of
    ``v`` changed — the union of the leaves' affected sets is a sound (and
    leaf-exact) invalidation set.  ``use_device`` pins the k-hop BFS
    routing; the device route runs on ``torch_device``.
    """
    if isinstance(window, (KHopWindow, TopologicalWindow)):
        return _leaf_affected(g_new, window, batch, use_device, torch_device)
    if isinstance(window, WindowExpr):
        leaves = {l for l in expr_leaves(window)}
        sets = [_leaf_affected(g_new, l, batch, use_device, torch_device)
                for l in leaves]
        return (np.unique(np.concatenate(sets)).astype(np.int32)
                if sets else np.empty(0, np.int32))
    raise TypeError(window)


def _shard_slices(g_new: Graph, window, batch: UpdateBatch, num_shards: int) -> list:
    """The per-shard work of :func:`sharded_affected_owners`: the batch's
    seed endpoints (k-hop), edge heads (topological) or edits (composite)
    cut into ``num_shards`` slices over the data axis."""
    parts = max(num_shards, 1)
    if isinstance(window, KHopWindow):
        return np.array_split(np.unique(_khop_seeds(g_new, batch)), parts)
    if isinstance(window, TopologicalWindow):
        return np.array_split(np.unique(batch.dst.astype(np.int64)), parts)
    if isinstance(window, WindowExpr):
        # composite windows: affected sets distribute over *batch* unions
        # (each leaf's set does), so slice the batch's edits
        return [UpdateBatch(batch.src[s], batch.dst[s], batch.op[s])
                for s in np.array_split(np.arange(batch.size), parts)]
    raise TypeError(window)


def _slice_owners(g_new: Graph, window, piece, use_device: Optional[bool],
                  torch_device) -> Array:
    """Affected owners of one :func:`_shard_slices` slice."""
    if (piece.size if isinstance(piece, UpdateBatch) else len(piece)) == 0:
        return np.empty(0, np.int32)
    if isinstance(window, KHopWindow):
        return affected_owners_khop_multi(g_new, window.k, piece, use_device=use_device,
                                          torch_device=torch_device)
    if isinstance(window, TopologicalWindow):
        return descendants_multi(g_new, piece)
    return affected_owners(g_new, window, piece, use_device=use_device,
                           torch_device=torch_device)


def sharded_affected_owners(
    g_new: Graph, window, batch: UpdateBatch, num_shards: int,
    use_device: Optional[bool] = None, torch_device="cuda",
) -> Tuple[Array, List[Array]]:
    """Distributed affected-set computation for one batch: the seed
    endpoints are sliced over ``num_shards`` (the data axis), each shard
    traverses only its slice's reverse balls / descendant cones, and the
    union is exactly the single-host affected set (BFS distributes over
    seed unions).  Returns ``(owners_union, per_shard_owners)`` — the
    per-shard sets are what each shard's dirty tile groups derive from.
    This form computes every slice in one process; :func:`spmd_affected_owners`
    is the form in which each rank traverses its own slice."""
    per_shard = [_slice_owners(g_new, window, piece, use_device, torch_device)
                 for piece in _shard_slices(g_new, window, batch, num_shards)]
    owners = (np.unique(np.concatenate(per_shard)).astype(np.int32)
              if per_shard else np.empty(0, np.int32))
    return owners, per_shard


def spmd_affected_owners(
    g_new: Graph, window, batch: UpdateBatch, num_shards: int, shard: int,
    group=None, use_device: Optional[bool] = None, torch_device="cuda",
) -> Tuple[Array, List[int]]:
    """:func:`sharded_affected_owners` run SPMD: this rank (``shard`` of
    ``num_shards`` in ``group``) traverses only its own slice (K2 on its
    own device when the slice takes the device route), then one
    ``all_reduce(SUM)`` of an int32 ``[n + num_shards]`` tensor on
    ``torch_device`` — the slice's owner mask and its size at position
    ``shard`` — gives every rank the union and every slice's size.
    Returns ``(owners_union, per_shard_sizes)``."""
    import torch
    import torch.distributed as dist

    piece = _shard_slices(g_new, window, batch, num_shards)[shard]
    mine = _slice_owners(g_new, window, piece, use_device, torch_device)
    buf = np.zeros(g_new.n + num_shards, np.int32)
    buf[mine] = 1
    buf[g_new.n + shard] = mine.size
    t = torch.from_numpy(buf).to(torch_device)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    got = t.cpu().numpy()
    owners = np.flatnonzero(got[: g_new.n]).astype(np.int32)
    return owners, [int(x) for x in got[g_new.n:]]


def affected_owners_khop(g_new: Graph, k: int, s: int, t: int) -> Array:
    """Single-edge wrapper (kept for compatibility)."""
    seeds = [s] if g_new.directed else [s, t]
    return affected_owners_khop_multi(g_new, k, np.asarray(seeds, np.int64))


def descendants(g: Graph, t: int) -> Array:
    """t plus all vertices reachable from t (directed)."""
    return descendants_multi(g, np.array([t], np.int64))


def containing_owners(index, g: Graph, window, vertices: Array) -> Array:
    """Owners whose windows *contain* any of the given vertices — the
    attribute-update invalidation set (an attr edit changes the cached
    aggregate of exactly the windows the edited vertex sits in; window
    membership itself is untouched).

    For a DBIndex the bipartite link structure already encodes the reverse
    mapping (:meth:`~repro_torch.core.dbindex.DBIndex.owners_of_members`); for an
    I-Index, ``u ∈ W_t(v)`` iff ``v`` is a descendant of ``u``, so the set
    is one forward multi-source BFS.
    """
    vertices = np.asarray(vertices, np.int64)
    if vertices.size == 0:
        return np.empty(0, np.int32)
    if isinstance(index, DBIndex):
        return index.owners_of_members(vertices)
    if isinstance(index, IIndex):
        return descendants_multi(g, vertices)
    raise TypeError(f"no reverse window map for {type(index).__name__}")


def _khop_seeds(g: Graph, batch: UpdateBatch) -> Array:
    """Endpoints whose reverse (k-1)-hop balls cover all affected owners:
    edge tails for directed graphs, both endpoints for undirected."""
    if g.directed:
        return batch.src.astype(np.int64)
    return np.concatenate([batch.src, batch.dst]).astype(np.int64)


# ---------------------- localized cone windows ------------------------ #
def _pack_members(members: Array, words: int) -> Array:
    b = np.zeros(words, dtype=np.uint64)
    m = np.asarray(members, np.int64)
    np.bitwise_or.at(b, m // 64, np.uint64(1) << (m % 64).astype(np.uint64))
    return b


def _unpack_bits(b: Array, n: int) -> Array:
    return np.flatnonzero(
        np.unpackbits(b.view(np.uint8), bitorder="little")[:n]
    ).astype(np.int32)


def _cone_windows_from_old(g_new: Graph, cone: Array, old_window_of, order: Array):
    """New topological windows for a descendant cone, touching nothing
    outside it.

    Any vertex whose window changed is *in* the cone, so an out-of-cone
    parent's window is unchanged — seed it from the existing index
    (``old_window_of``) instead of re-traversing the graph.  One sweep of
    the cone in topological order (``order``, computed once by the caller)
    then rebuilds each member's window as ``{v} ∪ parents' windows`` with
    packed-bitset unions (Algorithm 4 restricted to the cone).  Returns
    ``(wins, card)`` dicts over cone ∪ parents(cone): packed window
    bitsets and their cardinalities.
    """
    n = g_new.n
    words = (n + 63) // 64
    in_cone = np.zeros(n, dtype=bool)
    in_cone[cone] = True
    wins: dict = {}
    card: dict = {}
    for v in order:
        v = int(v)
        if not in_cone[v]:
            continue
        own = np.zeros(words, dtype=np.uint64)
        own[v // 64] |= np.uint64(1) << np.uint64(v % 64)
        for p in g_new.in_neighbors(v):
            p = int(p)
            if p not in wins:  # out-of-cone parent: old window still exact
                w = np.asarray(old_window_of(p), np.int64)
                wins[p] = _pack_members(w, words)
                card[p] = int(w.size)
            own |= wins[p]
        wins[v] = own
        card[v] = int(
            np.unpackbits(own.view(np.uint8), bitorder="little")[:n].sum()
        )
    return wins, card


# ------------------------- DBIndex maintenance ------------------------ #
def _merge_affected(index: DBIndex, owners: Array, wins: List[Array]) -> DBIndex:
    """Phase-1 merge: drop affected owners' links, append a secondary index
    over their new windows (paper §4.3)."""
    affected = np.zeros(index.n, dtype=bool)
    affected[owners] = True
    owner_ids = index.link_owner_ids
    keep = ~affected[owner_ids]
    kept_block = index.link_block[keep]
    kept_owner = owner_ids[keep]

    # secondary index: blocks over the new windows of affected owners
    b = _Builder(index.n)
    _blocks_from_windows(b, owners, wins)
    sec = b.finish({})

    # merge: secondary block ids offset by primary count
    nb0 = index.num_blocks
    sizes0 = np.diff(index.block_offsets)
    new_sizes = np.diff(sec.block_offsets)
    block_members = np.concatenate([index.block_members, sec.block_members])
    block_offsets = np.zeros(nb0 + sec.num_blocks + 1, dtype=np.int64)
    np.cumsum(np.concatenate([sizes0, new_sizes]), out=block_offsets[1:])
    lb_new = (sec.link_block + nb0).astype(np.int32)
    lo_new = sec.link_owner_ids.astype(np.int32)
    lb = np.concatenate([kept_block, lb_new])
    lo_ = np.concatenate([kept_owner, lo_new])
    order = np.lexsort((lb, lo_))
    lb, lo_ = lb[order], lo_[order]
    link_owner_offsets = np.zeros(index.n + 1, dtype=np.int64)
    np.cumsum(np.bincount(lo_, minlength=index.n), out=link_owner_offsets[1:])
    stats = dict(index.stats)
    stats["incremental_updates"] = stats.get("incremental_updates", 0) + 1
    stats["last_full_rebuild"] = False
    stats["last_affected_owners"] = int(owners.size)
    stats["last_secondary_blocks"] = int(sec.num_blocks)
    stats["num_blocks"] = nb0 + sec.num_blocks
    stats["num_links"] = int(lb.size)
    stats["num_members"] = int(block_members.size)
    return DBIndex(
        n=index.n,
        num_blocks=nb0 + sec.num_blocks,
        block_members=block_members,
        block_offsets=block_offsets,
        link_block=lb,
        link_owner_offsets=link_owner_offsets,
        stats=stats,
    )


def update_dbindex_batch(
    index: DBIndex, g_new: Graph, window, batch: UpdateBatch,
    owners: Optional[Array] = None, use_device: Optional[bool] = None,
    torch_device="cuda",
) -> Tuple[DBIndex, Array]:
    """Incremental phase-1 maintenance for a whole batch.

    Returns ``(new_index, affected_owners)``; the owner array is what the
    device-plan patchers need to splice only the changed tiles.  The
    primary prefix of the block arrays is unchanged by construction — new
    (secondary) blocks are strictly appended.  Exception: when the batch
    touches more than half the owners, an incremental merge would cost
    (and leak sharing) more than phase 2, so the index is rebuilt outright;
    the result carries ``stats["last_full_rebuild"] = True`` because the
    appended-prefix invariant does NOT hold then and plan patchers must
    rebuild rather than splice (``patch_plan_dbindex`` checks the flag).

    ``owners`` optionally supplies a precomputed affected-owner set so the
    BFS is not repeated here.  ``use_device`` pins the k-hop BFS routing
    (host NumPy vs the ``bitset_expand`` kernel on ``torch_device``);
    ignored when ``owners`` is given.
    """
    if batch.size == 0:
        return index, np.empty(0, np.int32)

    def rebuild():
        idx = reorganize(g_new, window)
        idx.stats["last_full_rebuild"] = True
        return idx, np.arange(index.n, dtype=np.int32)

    if owners is None:
        owners = affected_owners(g_new, window, batch, use_device=use_device,
                                 torch_device=torch_device)
    if owners.size > index.n // 2:
        return rebuild()
    if isinstance(window, KHopWindow):
        wins = khop_windows(g_new, window.k, owners)
    elif isinstance(window, TopologicalWindow):
        # localized: out-of-cone parents' windows come from the old index's
        # exact cover, so nothing outside the cone is traversed
        order = g_new.topological_order()
        packed, _ = _cone_windows_from_old(g_new, owners, index.window_of, order)
        wins = [_unpack_bits(packed[int(v)], index.n) for v in owners]
    elif isinstance(window, WindowExpr):
        # composite windows: re-evaluate the expression for the affected
        # owners only (batched bitset evaluation); the phase-1 merge and
        # everything downstream is window-agnostic
        wins = expr_windows(g_new, window, owners)
    else:
        raise TypeError(window)
    return _merge_affected(index, owners, wins), owners


def update_dbindex(index: DBIndex, g_new: Graph, window, s: int, t: int) -> DBIndex:
    """Single-edge wrapper over the batched path (op is irrelevant to the
    affected-owner computation, which only needs the touched endpoints)."""
    new_index, _ = update_dbindex_batch(
        index, g_new, window, UpdateBatch.inserts([s], [t])
    )
    return new_index


def reorganize(g: Graph, window, method: str = "emc", **kw) -> DBIndex:
    """Phase-2 periodic reorganization = fresh build (paper §4.3)."""
    if isinstance(window, TopologicalWindow):
        method = "mc"
    return build_dbindex(g, window, method=method, **kw)


# ------------------------- I-Index maintenance ------------------------ #
def update_iindex_batch(
    index: IIndex, g_new: Graph, batch: UpdateBatch
) -> Tuple[IIndex, Array]:
    """Localized rebuild of the union of descendant cones of all touched
    edge heads.  Returns ``(new_index, cone)``.

    Windows of the cone are rebuilt by one cone-restricted topological
    sweep seeded from the *old* index's windows for out-of-cone parents
    (their windows are unchanged by definition of the cone), so the update
    never traverses the graph outside the cone; PID/WD/level are then
    recomputed for the cone alone, and the flat WD arrays are spliced
    vectorized (no per-vertex Python rebuild of untouched entries).
    """
    if batch.size == 0:
        return index, np.empty(0, np.int32)
    cone = descendants_multi(g_new, batch.dst.astype(np.int64))
    if cone.size > index.n // 2:  # cheaper to rebuild outright
        return build_iindex(g_new), np.arange(index.n, dtype=np.int32)

    n = index.n
    in_cone = np.zeros(n, dtype=bool)
    in_cone[cone] = True
    order = g_new.topological_order()  # one Kahn pass, shared with the sweep
    wins, card = _cone_windows_from_old(g_new, cone, index.window_of, order)

    pid = index.pid.copy()
    level = index.level.copy()
    wd_new: List[Array] = []
    cone_order: List[int] = []
    for v in order:
        v = int(v)
        if not in_cone[v]:
            continue
        parents = g_new.in_neighbors(v)
        best, best_c = -1, -1
        for p in parents:
            c = card[int(p)]
            if c > best_c:
                best_c, best = c, int(p)
        if best != -1:
            wd = _unpack_bits(wins[v] & ~wins[best], n)
        else:
            wd = _unpack_bits(wins[v], n)
        pid[v] = best
        level[v] = 0 if best == -1 else level[best] + 1
        wd_new.append(wd)
        cone_order.append(v)

    # vectorized splice: keep untouched owners' WD rows, replace the cone's
    old_sizes = np.diff(index.wd_offsets)
    owner_old = np.repeat(np.arange(n, dtype=np.int64), old_sizes)
    keep = ~in_cone[owner_old]
    new_sizes = np.array([w.size for w in wd_new], dtype=np.int64)
    all_owner = np.concatenate(
        [owner_old[keep], np.repeat(np.asarray(cone_order, np.int64), new_sizes)]
    )
    all_members = np.concatenate(
        [index.wd_members[keep]] + ([np.concatenate(wd_new)] if wd_new else [])
    ) if all_owner.size else np.empty(0, np.int32)
    order2 = np.argsort(all_owner, kind="stable")
    wd_members = all_members[order2].astype(np.int32)
    wd_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(all_owner, minlength=n), out=wd_offsets[1:])

    stats = dict(index.stats)
    stats["incremental_updates"] = stats.get("incremental_updates", 0) + 1
    stats["last_cone_size"] = int(cone.size)
    stats["num_wd_entries"] = int(wd_members.size)
    return (
        IIndex(
            n=n,
            pid=pid,
            wd_members=wd_members,
            wd_offsets=wd_offsets,
            level=level,
            topo_order=order,
            stats=stats,
        ),
        cone,
    )


def update_iindex(index: IIndex, g_new: Graph, s: int, t: int) -> IIndex:
    """Single-edge wrapper over the batched path."""
    new_index, _ = update_iindex_batch(index, g_new, UpdateBatch.inserts([s], [t]))
    return new_index


# ------------------------- serialization (WAL) ------------------------ #
# One UpdateBatch <-> bytes, for the write-ahead log and the replication
# stream.  Layout (all little-endian, arrays raw C-order):
#
#   magic "UB1\0" | flags u8 | n_attr_edits u16 | n_structural u64
#   src i32[m] | dst i32[m] | op i8[m] | [ts f64[m] if flags & 1]
#   per attr edit:
#     name_len u16 | dtype_len u8 | k u64 | name utf-8 | dtype np-str
#     vertices i64[k] | values dtype[k]
#
# The encoding is deterministic (same batch -> same bytes), so WAL records
# can be checksummed and replicas can be diffed byte-for-byte.
_CODEC_MAGIC = b"UB1\x00"
_CODEC_HDR = "<BHQ"
_CODEC_EDIT_HDR = "<HBQ"


def encode_update_batch(batch: UpdateBatch) -> bytes:
    import struct

    flags = 1 if batch.ts is not None else 0
    out = [
        _CODEC_MAGIC,
        struct.pack(_CODEC_HDR, flags, len(batch.attr_edits), batch.size),
        np.ascontiguousarray(batch.src, np.int32).tobytes(),
        np.ascontiguousarray(batch.dst, np.int32).tobytes(),
        np.ascontiguousarray(batch.op, np.int8).tobytes(),
    ]
    if batch.ts is not None:
        out.append(np.ascontiguousarray(batch.ts, np.float64).tobytes())
    for e in batch.attr_edits:
        name = e.name.encode("utf-8")
        dt = np.dtype(e.values.dtype).str.encode("ascii")  # e.g. b"<f4"
        out.append(struct.pack(_CODEC_EDIT_HDR, len(name), len(dt),
                               e.vertices.size))
        out.append(name)
        out.append(dt)
        out.append(np.ascontiguousarray(e.vertices, np.int64).tobytes())
        out.append(np.ascontiguousarray(e.values).tobytes())
    return b"".join(out)


def decode_update_batch(data: bytes) -> UpdateBatch:
    import struct

    mv = memoryview(data)
    if bytes(mv[:4]) != _CODEC_MAGIC:
        raise ValueError("not an UpdateBatch record (bad magic)")
    off = 4
    flags, n_edits, m = struct.unpack_from(_CODEC_HDR, mv, off)
    off += struct.calcsize(_CODEC_HDR)

    def take(dtype, count):
        nonlocal off
        dt = np.dtype(dtype)
        end = off + dt.itemsize * count
        if end > len(data):
            raise ValueError("truncated UpdateBatch record")
        arr = np.frombuffer(mv, dtype=dt, count=count, offset=off).copy()
        off = end
        return arr

    src = take(np.int32, m)
    dst = take(np.int32, m)
    op = take(np.int8, m)
    ts = take(np.float64, m) if flags & 1 else None
    edits = []
    for _ in range(n_edits):
        name_len, dt_len, k = struct.unpack_from(_CODEC_EDIT_HDR, mv, off)
        off += struct.calcsize(_CODEC_EDIT_HDR)
        name = bytes(mv[off: off + name_len]).decode("utf-8")
        off += name_len
        dt = np.dtype(bytes(mv[off: off + dt_len]).decode("ascii"))
        off += dt_len
        verts = take(np.int64, k)
        vals = take(dt, k)
        edits.append(AttrEdit(name, verts, vals))
    if off != len(data):
        raise ValueError(f"{len(data) - off} trailing byte(s) after record")
    return UpdateBatch(src, dst, op, ts, tuple(edits))

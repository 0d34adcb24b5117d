"""Dense Block Index (paper §4).

Construction follows the paper's two-step heuristic:

1. **Cluster** vertices (window *owners*) by MinHash signature of their
   windows — MC uses the full k-hop signature, EMC a cheaper k'-hop estimate
   (§4.2.2).  Signatures are computed by segment-min message passing without
   any window materialization (:mod:`repro_torch.core.minhash`).
2. **Partition into blocks**: per cluster, partition the window *members*
   into equivalence classes — two members are equivalent iff they appear in
   exactly the same set of the cluster's windows (paper's node equivalence).
   Each class is a block; a block is *dense* if it has >= 2 members and
   >= 2 owners.  Links ``block -> owner`` record the exact disjoint cover of
   every window.

Implementation notes (vectorized; DESIGN.md §2):

* Windows are materialized **per owner-batch** as packed bitsets (one
  multi-source BFS per ~4096 owners, whole clusters packed per batch), never
  all at once — this is the paper's memory argument against EAGR, kept.
* The equivalence partition is one ``lexsort`` over (cluster, member, owner)
  pairs + ``reduceat`` owner-set hashing (128-bit order-independent), one
  ``np.unique`` for block ids — no Python loop over members.
* Oversized clusters are sub-chunked to a pair budget (the paper's recursive
  re-partition of clusters that don't fit in memory).
* With an exact owner-set partition the paper's ``RefineCluster`` recursion
  reaches its fixed point in one pass (owner-set equality is the finest
  useful refinement), so output semantics match at lower cost.

The built index is a bipartite blocks↔owners structure (paper Fig. 3) stored
as flat sorted arrays ready for the device data plane:

* pass 1: ``T[b]   = Σ attr[block_members[b]]``   (segment-reduce by block)
* pass 2: ``ans[v] = Σ T[link_block under owner v]`` (segment-reduce by owner)
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import minhash as mh
from repro_torch.core.aggregates import AGGREGATES, Aggregate
from repro_torch.core.graph import Graph
from repro_torch.core.windows import (
    KHopWindow,
    TopologicalWindow,
    WindowExpr,
    expr_reach_bitsets,
    khop_reach_bitsets,
)

Array = np.ndarray

_C1 = np.uint64(0x517CC1B727220A95)
_C2 = np.uint64(0x2545F4914F6CDD1D)
_C3 = np.uint64(0x27D4EB2F165667C5)


@dataclasses.dataclass(frozen=True)
class DBIndex:
    """Bipartite block index (static arrays; ids int32)."""

    n: int
    num_blocks: int
    block_members: Array  # int32 [M] member vertex ids, grouped by block
    block_offsets: Array  # int64 [num_blocks+1]
    link_block: Array  # int32 [L] block ids, grouped by owner
    link_owner_offsets: Array  # int64 [n+1] CSR over owners
    stats: Dict = dataclasses.field(default_factory=dict, repr=False)

    # ---------------------------------------------------------------- #
    # the expanded id vectors are memoized on the (immutable) index —
    # plan building/patching and the attr-edit reverse lookup all consume
    # them, and re-materializing O(M)/O(L) arrays per call is pure waste
    @property
    def member_block_ids(self) -> Array:
        cached = getattr(self, "_member_block_ids", None)
        if cached is None:
            sizes = np.diff(self.block_offsets)
            cached = np.repeat(np.arange(self.num_blocks, dtype=np.int32), sizes)
            object.__setattr__(self, "_member_block_ids", cached)
        return cached

    @property
    def link_owner_ids(self) -> Array:
        cached = getattr(self, "_link_owner_ids", None)
        if cached is None:
            sizes = np.diff(self.link_owner_offsets)
            cached = np.repeat(np.arange(self.n, dtype=np.int32), sizes)
            object.__setattr__(self, "_link_owner_ids", cached)
        return cached

    def block(self, b: int) -> Array:
        return self.block_members[self.block_offsets[b] : self.block_offsets[b + 1]]

    def owner_blocks(self, v: int) -> Array:
        return self.link_block[self.link_owner_offsets[v] : self.link_owner_offsets[v + 1]]

    def window_of(self, v: int) -> Array:
        """Reconstruct W(v) from the cover — used by invariant tests."""
        parts = [self.block(b) for b in self.owner_blocks(v)]
        return np.sort(np.concatenate(parts)) if parts else np.empty(0, np.int32)

    def size_bytes(self) -> int:
        return int(
            self.block_members.nbytes
            + self.block_offsets.nbytes
            + self.link_block.nbytes
            + self.link_owner_offsets.nbytes
        )

    def linked_blocks_mask(self) -> Array:
        """Bool [num_blocks]: which blocks at least one owner links to."""
        linked = np.zeros(self.num_blocks, dtype=bool)
        linked[self.link_block] = True
        return linked

    def garbage_block_fraction(self, linked: Optional[Array] = None) -> float:
        """Fraction of blocks no owner links to (zero-link = garbage).

        Delete-dominated streams shrink windows: phase-1 merges drop the
        affected owners' links and append smaller secondary blocks, so old
        blocks lose their last link without the links/blocks *growth*
        ratios ever tripping — this is the direct staleness signal for
        them, shared by :class:`repro_torch.core.streaming.StalenessPolicy` and
        the pass-1 compaction in
        :func:`repro_torch.core.engine_torch.patch_plan_dbindex` (which passes its
        already-computed ``linked`` mask to avoid a second scan).
        """
        if self.num_blocks == 0:
            return 0.0
        if linked is None:
            linked = self.linked_blocks_mask()
        return 1.0 - int(np.count_nonzero(linked)) / self.num_blocks

    # ----------------------- reverse link map ------------------------ #
    def owners_of_members(self, vertices: Array) -> Array:
        """Owners whose windows contain any of the given vertices.

        The bipartite structure already encodes the reverse mapping: a
        vertex sits in some blocks (member lists), and the owners linking
        any of those blocks are exactly the windows containing it.  This is
        the attribute-update invalidation set — an attr edit changes only
        the cached aggregates of these owners (membership is untouched).
        """
        vertices = np.asarray(vertices, np.int64)
        if vertices.size == 0 or self.block_members.size == 0:
            return np.empty(0, np.int32)
        hit = np.zeros(self.n + 1, dtype=bool)
        hit[np.clip(vertices, 0, self.n)] = True
        blocks = np.unique(self.member_block_ids[hit[self.block_members]])
        if blocks.size == 0:
            return np.empty(0, np.int32)
        bmask = np.zeros(self.num_blocks, dtype=bool)
        bmask[blocks] = True
        return np.unique(self.link_owner_ids[bmask[self.link_block]]).astype(
            np.int32)

    # ------------------------- query (NumPy) ------------------------- #
    def query(self, values: Array, agg: str = "sum") -> Array:
        """Two-stage shared aggregation (paper §4.1), NumPy executor.

        Dtype-safe: integer attributes ride int64 channels end to end with
        per-dtype monoid identities — the serving layer's bitwise oracle
        depends on the int path never silently upcasting to float (only a
        finalizer may change the dtype).
        """
        a: Aggregate = AGGREGATES[agg]
        chans = a.prepare(np.asarray(values))
        outs = []
        for monoid, chan in zip(a.monoids, chans):
            ident = monoid.identity_for(chan.dtype)
            # pass 1: per-block partials
            t = np.full(self.num_blocks, ident, dtype=chan.dtype)
            if self.block_members.size:
                gathered = chan[self.block_members]
                starts = self.block_offsets[:-1]
                nonempty = np.diff(self.block_offsets) > 0
                red = monoid.np_op.reduceat(gathered, np.minimum(starts, gathered.size - 1))
                t = np.where(nonempty, red, ident)
            # pass 2: combine partials per owner
            ans = np.full(self.n, ident, dtype=chan.dtype)
            if self.link_block.size:
                g2 = t[self.link_block]
                starts2 = self.link_owner_offsets[:-1]
                nonempty2 = np.diff(self.link_owner_offsets) > 0
                red2 = monoid.np_op.reduceat(g2, np.minimum(starts2, g2.size - 1))
                ans = np.where(nonempty2, red2, ident)
            assert ans.dtype == chan.dtype, (
                f"monoid channel upcast: {chan.dtype} -> {ans.dtype}")
            outs.append(ans)
        return a.finalize_np(*outs)


# -------------------------------------------------------------------- #
#  Vectorized equivalence partition
# -------------------------------------------------------------------- #
class _Builder:
    """Accumulates blocks/links across owner batches with global dedup."""

    def __init__(self, n: int):
        self.n = n
        self.registry: Dict[Tuple[int, int, int], int] = {}
        self.block_chunks: List[Array] = []
        self.block_size_chunks: List[Array] = []
        self.link_block_chunks: List[Array] = []
        self.link_owner_chunks: List[Array] = []
        self.num_blocks = 0
        self.num_dense = 0

    def add_pairs(self, member: Array, owner: Array, cluster: Array) -> None:
        """Partition (cluster, member, owner) incidence pairs into blocks.

        member/owner are global vertex ids; cluster scopes the equivalence.
        """
        if member.size == 0:
            return
        member = member.astype(np.int64, copy=False)
        owner = owner.astype(np.int64, copy=False)
        cluster = cluster.astype(np.int64, copy=False)
        # owner order within a (cluster, member) segment is irrelevant (the
        # owner-set hash is order-independent), so one combined-key argsort
        # replaces a 3-key lexsort.
        combined = cluster * np.int64(self.n + 1) + member
        order = np.argsort(combined, kind="stable")
        m = member[order]
        o = owner[order]
        c = cluster[order]
        comb = combined[order]
        new_seg = np.empty(m.size, dtype=bool)
        new_seg[0] = True
        np.not_equal(np.diff(comb), 0, out=new_seg[1:])
        seg_starts = np.flatnonzero(new_seg)
        seg_len = np.diff(np.append(seg_starts, m.size))
        # 128-bit order-independent owner-set hash per (cluster, member) seg
        oh_a = mh._splitmix64(o.astype(np.uint64) * _C1)
        oh_b = mh._splitmix64(o.astype(np.uint64) ^ _C2)
        ha = np.add.reduceat(oh_a, seg_starts)
        hb = np.add.reduceat(oh_b, seg_starts)
        seg_member = m[seg_starts]
        seg_cluster = c[seg_starts]
        # block key: mix of (cluster, owner-set hash pair, size) -> uint64
        key = mh._splitmix64(
            ha
            ^ mh._splitmix64(hb ^ mh._splitmix64(seg_cluster.astype(np.uint64) * _C3))
            ^ (seg_len.astype(np.uint64) * _C2)
        )
        _, inv = np.unique(key, return_inverse=True)
        order2 = np.argsort(inv, kind="stable")
        inv_sorted = inv[order2]
        bstarts = np.flatnonzero(np.diff(inv_sorted, prepend=-1))
        bsizes = np.diff(np.append(bstarts, inv_sorted.size))
        blk_members = seg_member[order2]  # ascending within each block
        # content hash for global dedup
        mh_mix = mh._splitmix64(blk_members.astype(np.uint64) * _C3)
        chash = np.add.reduceat(mh_mix, bstarts)
        first = blk_members[bstarts]
        # owner lists come from each block's representative segment
        rep_seg = order2[bstarts]
        rep_start = seg_starts[rep_seg]
        rep_len = seg_len[rep_seg]
        # dense blocks: >=2 members and >=2 owners
        self.num_dense += int(np.count_nonzero((bsizes >= 2) & (rep_len >= 2)))
        # global ids with dedup
        nb = bstarts.size
        gids = np.empty(nb, dtype=np.int64)
        reg = self.registry
        new_mask = np.zeros(nb, dtype=bool)
        for i in range(nb):
            k = (int(chash[i]), int(bsizes[i]), int(first[i]))
            gid = reg.get(k)
            if gid is None:
                gid = self.num_blocks
                reg[k] = gid
                self.num_blocks += 1
                new_mask[i] = True
            gids[i] = gid
        # store only new blocks' member lists
        if new_mask.any():
            keep_members = np.repeat(new_mask, bsizes)
            self.block_chunks.append(blk_members[keep_members].astype(np.int32))
            self.block_size_chunks.append(bsizes[new_mask])
            # gids of new blocks are consecutive by construction order
        # links: block gid -> owners of representative segment
        total_links = int(rep_len.sum())
        idx = np.repeat(rep_start, rep_len) + (
            np.arange(total_links) - np.repeat(np.cumsum(rep_len) - rep_len, rep_len)
        )
        self.link_owner_chunks.append(o[idx].astype(np.int32))
        self.link_block_chunks.append(np.repeat(gids, rep_len).astype(np.int32))

    def finish(self, stats: Dict) -> DBIndex:
        n = self.n
        if self.num_blocks:
            block_members = np.concatenate(self.block_chunks)
            sizes = np.concatenate(self.block_size_chunks)
            block_offsets = np.zeros(self.num_blocks + 1, dtype=np.int64)
            np.cumsum(sizes, out=block_offsets[1:])
            lb = np.concatenate(self.link_block_chunks)
            lo_ = np.concatenate(self.link_owner_chunks)
            lorder = np.lexsort((lb, lo_))
            lb, lo_ = lb[lorder], lo_[lorder]
            link_owner_offsets = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(np.bincount(lo_, minlength=n), out=link_owner_offsets[1:])
        else:
            block_members = np.empty(0, np.int32)
            block_offsets = np.zeros(1, np.int64)
            lb = np.empty(0, np.int32)
            link_owner_offsets = np.zeros(n + 1, np.int64)
        stats.update(
            num_blocks=self.num_blocks,
            num_dense_blocks=self.num_dense,
            num_links=int(lb.size),
            num_members=int(block_members.size),
        )
        return DBIndex(
            n=n,
            num_blocks=self.num_blocks,
            block_members=block_members,
            block_offsets=block_offsets,
            link_block=lb,
            link_owner_offsets=link_owner_offsets,
            stats=stats,
        )


def _blocks_from_windows(
    builder: _Builder, owners: Array, windows: List[Array], cluster_ids: Optional[Array] = None
) -> None:
    """Compatibility shim (used by incremental updates): explicit windows."""
    lens = np.array([w.size for w in windows], dtype=np.int64)
    if lens.sum() == 0:
        return
    member = np.concatenate(windows)
    owner = np.repeat(np.asarray(owners, np.int64), lens)
    if cluster_ids is None:
        cl = np.zeros(member.size, dtype=np.int64)
    else:
        cl = np.repeat(np.asarray(cluster_ids, np.int64), lens)
    builder.add_pairs(member.astype(np.int64), owner, cl)


# -------------------------------------------------------------------- #
#  Construction driver
# -------------------------------------------------------------------- #
def _pairs_from_packed(mat: Array) -> Tuple[Array, Array]:
    """(row, col) indices of set bits in a packed uint64 matrix [R, W].

    Sparse-aware: only nonzero words are expanded (64x less scan than a full
    unpackbits at low densities).  Column index = word*64 + bit.
    """
    rows, wcols = np.nonzero(mat)
    if rows.size == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    vals = np.ascontiguousarray(mat[rows, wcols])
    bits = np.unpackbits(vals.view(np.uint8).reshape(-1, 8), axis=1, bitorder="little")
    nz_r, nz_b = np.nonzero(bits)
    return rows[nz_r].astype(np.int64), (wcols[nz_r] * 64 + nz_b).astype(np.int64)


def _paper_signatures_khop(
    g: Graph, k: int, num_hashes: int, bfs_batch: int, seed: int
) -> Array:
    """MinHash by explicit window materialization (paper's MC first pass)."""
    h = mh.vertex_hashes(g.n, num_hashes, seed)
    sig = np.full((g.n, num_hashes), np.iinfo(np.uint64).max, dtype=np.uint64)
    all_src = np.arange(g.n, dtype=np.int32)
    for lo in range(0, g.n, bfs_batch):
        batch = all_src[lo : lo + bfs_batch]
        reach = khop_reach_bitsets(g, k, batch)
        member, owner_local = _pairs_from_packed(reach)
        order = np.argsort(owner_local, kind="stable")
        m_s, o_s = member[order], owner_local[order]
        starts = np.flatnonzero(np.diff(o_s, prepend=-1))
        owners = batch[o_s[starts]]
        red = np.minimum.reduceat(h[m_s], starts, axis=0)
        sig[owners] = red
    return sig


def _expr_signatures(g: Graph, expr, num_hashes: int, bfs_batch: int,
                     seed: int) -> Array:
    """MinHash signatures of composite-expression windows, by batched
    materialization (the only generic option: a combinator's member set is
    not reachable by message passing alone).  Same pattern as the paper's
    MC first pass, with the window materializer swapped for the expression
    evaluator — everything downstream (clustering, equivalence partition,
    blocks) is unchanged, which is the point: DBIndex is window-agnostic."""
    h = mh.vertex_hashes(g.n, num_hashes, seed)
    sig = np.full((g.n, num_hashes), np.iinfo(np.uint64).max, dtype=np.uint64)
    all_src = np.arange(g.n, dtype=np.int32)
    for lo in range(0, g.n, bfs_batch):
        batch = all_src[lo : lo + bfs_batch]
        reach = expr_reach_bitsets(g, expr, batch)
        member, owner_local = _pairs_from_packed(reach)
        if member.size == 0:
            continue
        order = np.argsort(owner_local, kind="stable")
        m_s, o_s = member[order], owner_local[order]
        starts = np.flatnonzero(np.diff(o_s, prepend=-1))
        owners = batch[o_s[starts]]
        red = np.minimum.reduceat(h[m_s], starts, axis=0)
        sig[owners] = red
    return sig


def _topo_ancestor_bitsets(g: Graph) -> Array:
    """Packed ancestor matrix [n, ceil(n/64)] (row v = W_t(v))."""
    order = g.topological_order()
    words = (g.n + 63) // 64
    anc = np.zeros((g.n, words), dtype=np.uint64)
    ids = np.arange(g.n, dtype=np.int64)
    anc[ids, ids // 64] |= np.uint64(1) << (ids % 64).astype(np.uint64)
    for v in order:
        ch = g.out_neighbors(v)
        if ch.size:
            anc[ch] |= anc[v]
    return anc


def build_dbindex(
    g: Graph,
    window,
    method: str = "mc",
    num_hashes: int = 2,
    cluster_hops: Optional[int] = None,
    bfs_batch: int = 4096,
    pair_budget: int = 8_000_000,
    seed: int = 0,
) -> DBIndex:
    """Build a DBIndex.

    method: "mc" (cluster on full window signatures) or "emc" (cluster on
    `cluster_hops`-hop signatures; default 1) — EMC only defined for k-hop
    windows (§4.2.2).

    Composite :class:`~repro_torch.core.windows.WindowExpr` windows (combinators,
    direction-variant k-hop leaves) take the generic path: signatures by
    batched expression materialization, then the *same* clustering /
    equivalence-partition / block pipeline — dense-block sharing works for
    any window sets (the paper's own observation), so the device plans,
    patching and sharding downstream apply unchanged.
    """
    t0 = time.perf_counter()
    is_khop = isinstance(window, KHopWindow)
    is_expr = isinstance(window, WindowExpr) and not isinstance(
        window, (KHopWindow, TopologicalWindow))
    if is_expr:
        method = "expr"
        sig = _expr_signatures(g, window, num_hashes, bfs_batch, seed)
    elif is_khop:
        if method == "mc_paper":
            # Paper Algorithm 1 lines 2-5 verbatim: materialize each window
            # (first of two BFS passes) and hash its member list.  Kept for
            # the Fig-7 reproduction; `mc` below is our message-passing
            # signature that removes this pass entirely (EXPERIMENTS §Perf).
            sig = _paper_signatures_khop(g, window.k, num_hashes, bfs_batch, seed)
        elif method == "mc":
            sig = mh.minhash_signatures_khop(g, window.k, num_hashes, seed)
        elif method == "emc":
            sig_hops = cluster_hops or 1
            assert sig_hops <= window.k
            sig = mh.minhash_signatures_khop(g, sig_hops, num_hashes, seed)
        else:
            raise ValueError(method)
    elif isinstance(window, TopologicalWindow):
        if method == "emc":
            raise ValueError("EMC is defined for k-hop windows only (paper §4.2.2)")
        sig = mh.minhash_signatures_topo(g, num_hashes, seed)
    else:
        raise TypeError(window)
    cluster_ids = mh.cluster_by_signature(sig)
    t_hash = time.perf_counter() - t0

    # owners in cluster-contiguous order
    order = np.argsort(cluster_ids, kind="stable").astype(np.int32)
    cl_sorted = cluster_ids[order]

    builder = _Builder(g.n)
    t1 = time.perf_counter()
    # expression windows share the k-hop orientation ([member, owner] packed
    # matrix per source batch), so they ride the same pair-extraction path
    packed_cols = is_khop or is_expr
    anc = _topo_ancestor_bitsets(g) if not packed_cols else None

    for blo in range(0, g.n, bfs_batch):
        sources = order[blo : blo + bfs_batch]
        src_clusters = cl_sorted[blo : blo + bfs_batch].astype(np.int64)
        if packed_cols:
            reach = (
                khop_reach_bitsets(g, window.k, sources) if is_khop
                else expr_reach_bitsets(g, window, sources)
            )  # [n, words]
        # extract (owner_local, member) pairs in column chunks; split the
        # partition scope at the pair budget (prefer cluster boundaries)
        pend_member: List[Array] = []
        pend_owner: List[Array] = []
        pend_cluster: List[Array] = []
        pend_count = 0

        def flush():
            nonlocal pend_count
            if pend_count:
                builder.add_pairs(
                    np.concatenate(pend_member),
                    np.concatenate(pend_owner),
                    np.concatenate(pend_cluster),
                )
            pend_member.clear()
            pend_owner.clear()
            pend_cluster.clear()
            pend_count = 0

        col_chunk = 1024
        for clo in range(0, sources.size, col_chunk):
            chi = min(clo + col_chunk, sources.size)
            if packed_cols:
                sub = reach[:, clo // 64 : (chi + 63) // 64]
                member, owner_local = _pairs_from_packed(sub)
            else:
                rows = anc[sources[clo:chi].astype(np.int64)]
                owner_local, member = _pairs_from_packed(rows)
                keep = member < g.n
                member, owner_local = member[keep], owner_local[keep]
            owner_local = owner_local + clo
            pend_member.append(member.astype(np.int64))
            pend_owner.append(sources[owner_local].astype(np.int64))
            pend_cluster.append(src_clusters[owner_local])
            pend_count += member.size
            if pend_count >= pair_budget:
                flush()
        flush()
    t_blocks = time.perf_counter() - t1

    stats = {
        "method": method,
        "t_hash_s": t_hash,
        "t_blocks_s": t_blocks,
        "t_total_s": time.perf_counter() - t0,
        "num_clusters": int(cluster_ids.max()) + 1 if g.n else 0,
    }
    return builder.finish(stats)

"""Device (PyTorch/CUDA) query data plane for the DBIndex and the I-Index.

The host-built index becomes a static *plan* of device tensors.  DBIndex:
two chained tile plans — members→blocks, then links→owners — each one
fused gather + segment sum (kernel K1, DESIGN.md §2).  I-Index: one tile
plan over the window differences (K1), then the inheritance scan along the
PID forest (:func:`query_iindex_multi`, paper Algorithm 5).

:func:`query_dbindex_multi` is the fused multi-aggregate executor behind
:mod:`repro_torch.core.api`: one K1 launch per pass feeds every channel
(the channels stack into the columns of one matrix, each with its monoid —
sum, min or max; a ``[B, n]`` batch of attribute vectors adds ``B`` columns
per channel), and min/max ride dense ELL layouts instead when the plan has
them, so k aggregates over one window cost roughly one query instead of k.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.aggregates import TORCH_XP, pack_channels
from repro_torch.core.dbindex import DBIndex
from repro_torch.core.iindex import IIndex
from repro_torch.device import resolve_device, upload
from repro_torch.kernels.inherit_scan.ops import Forest, forest_layout, inherit
from repro_torch.kernels.segment_reduce.ops import (
    TilePlan,
    _nbytes,
    build_tile_plan,
    patch_tile_plan,
    segment_reduce_multi,
)

# ---------------------------------------------------------------------- #
#  DBIndex plan
# ---------------------------------------------------------------------- #
#: ELL pad slot; :func:`_ell_reduce` clamps it to the appended identity row
_ELL_SENTINEL = np.int32(np.iinfo(np.int32).max)


@dataclasses.dataclass(frozen=True)
class DBIndexPlan:
    """Device plan.  ``block_capacity >= num_blocks`` pads the block-partial
    vector ``T`` so that streamed updates appending secondary blocks keep
    static shapes (capacity grows by powers of two → O(log) shape changes
    over a stream instead of one per batch).

    ``p1_ell`` / ``p2_ell`` are padded per-segment row layouts (ELL style)
    for the idempotent monoids: blocks and owner link lists have tiny
    bounded fan-in, so min/max evaluate as one dense gather + axis reduce
    instead of a scatter.  min/max are order-insensitive, so the
    formulation is bit-exact against any other evaluation order.  Pad slots
    hold ``_ELL_SENTINEL``, which the query clamps to an appended row
    holding the monoid identity."""

    n: int
    num_blocks: int
    block_capacity: int
    pass1: TilePlan  # members -> block partials
    pass2: TilePlan  # block partials -> owner windows
    block_sizes: torch.Tensor  # f32 [block_capacity] (for count/avg)
    link_counts: torch.Tensor  # f32 [n]
    device: torch.device
    p1_ell: Optional[torch.Tensor] = None  # i32 [block_capacity, R1] member ids
    p2_ell: Optional[torch.Tensor] = None  # i32 [n, R2] block ids

    def named_arrays(self) -> dict:
        """The plan's tensors keyed ``pass1.<name>`` / ``pass2.<name>`` /
        top-level array name (the reference's ``array_nbytes`` keys): what
        :meth:`array_nbytes` counts and the audit digest folds."""
        out = {}
        for prefix, tp in (("pass1", self.pass1), ("pass2", self.pass2)):
            for k, t in tp.named_arrays().items():
                out[f"{prefix}.{k}"] = t
        for name in ("block_sizes", "link_counts", "p1_ell", "p2_ell"):
            t = getattr(self, name)
            if t is not None:
                out[name] = t
        return out

    def array_nbytes(self) -> dict:
        """Exact per-array device bytes, keyed as :meth:`named_arrays`."""
        return {k: _nbytes(t) for k, t in self.named_arrays().items()}

    def clone(self) -> "DBIndexPlan":
        """The same plan in fresh storage (device-to-device copies on the
        current stream): a patch of the clone leaves this plan as it is."""
        return dataclasses.replace(
            self, pass1=self.pass1.clone(), pass2=self.pass2.clone(),
            **{name: getattr(self, name).clone()
               for name in ("block_sizes", "link_counts", "p1_ell", "p2_ell")
               if getattr(self, name) is not None})

    def plan_nbytes(self) -> int:
        """Total device bytes held by this plan (sum of per-array sizes)."""
        return sum(self.array_nbytes().values())

    def shape_signature(self) -> tuple:
        """Every tensor shape of the plan — what a compiled executor would
        specialize on (``num_blocks`` is data, not shape)."""
        tensors = (self.pass1.gather_padded, self.pass1.seg_tiles,
                   self.pass2.gather_padded, self.pass2.seg_tiles,
                   self.block_sizes, self.link_counts, self.p1_ell,
                   self.p2_ell)
        return tuple(None if t is None else tuple(t.shape) for t in tensors)


def _block_sizes_padded(index: DBIndex, capacity: int) -> np.ndarray:
    sizes = np.zeros(capacity, np.float32)
    sizes[: index.num_blocks] = np.diff(index.block_offsets)
    return sizes


def _pow2(x: int) -> int:
    return 1 << (max(int(x), 1) - 1).bit_length()


def _ell_rows(offsets: np.ndarray, items: np.ndarray, num_rows: int,
              width: int) -> np.ndarray:
    """Padded per-segment item matrix [num_rows, width], sentinel-padded."""
    out = np.full((num_rows, width), _ELL_SENTINEL, np.int32)
    sizes = np.diff(offsets).astype(np.int64)
    row = np.repeat(np.arange(sizes.size, dtype=np.int64), sizes)
    pos = np.arange(items.size) - np.repeat(offsets[:-1], sizes)
    out[row, pos] = items
    return out


def _ell_from_index(index: DBIndex, cap: int, dev: torch.device):
    """(p1_ell, p2_ell) for the min/max fast path, or (None, None) when a
    degenerate fan-in distribution would blow the padded layout up (the
    scatter path stays available — min/max are exact either way)."""
    max_block = int(np.diff(index.block_offsets).max()) if index.num_blocks else 1
    max_links = int(np.diff(index.link_owner_offsets).max()) if index.n else 1
    r1, r2 = _pow2(max_block), _pow2(max_links)
    # the same padding guard as the reference plan, so both packages pick
    # the same layout for the same index
    if (cap * r1 > max(16 * index.block_members.size, 1 << 16)
            or index.n * r2 > max(16 * index.link_block.size, 1 << 16)):
        return None, None
    p1 = _ell_rows(index.block_offsets, index.block_members, cap, r1)
    p2 = _ell_rows(index.link_owner_offsets, index.link_block, index.n, r2)
    return upload(p1, dev), upload(p2, dev)


def plan_from_dbindex(
    index: DBIndex, tm: int = 512, ts: int = 512,
    block_capacity: Optional[int] = None, headroom: float = 0.0,
    torch_device="cuda",
) -> DBIndexPlan:
    dev = resolve_device(torch_device)
    cap = max(int(block_capacity or 0), index.num_blocks, 1)
    floors = None
    if headroom > 0:
        # pre-pad the block id space to the next power of two past the
        # headroom so streamed secondary-block appends don't change the
        # capacity (and hence the shapes) on the first few batches
        cap = _pow2(int(cap * (1 + headroom)))
        # appended secondary blocks take consecutive ids just past
        # num_blocks, so the growth lands in a handful of specific tile
        # groups — floor those at the expected rows of a full group of
        # average-sized blocks instead of spreading slack uniformly
        n_groups = max(1, -(-cap // ts))
        avg_block = index.block_members.size / max(index.num_blocks, 1)
        boost = -(-int(ts * avg_block * (1 + headroom)) // tm)
        floors = np.ones(n_groups, np.int64)
        g0 = index.num_blocks // ts
        floors[g0: g0 + 4] = max(boost, 1)
    member_block = np.asarray(index.member_block_ids, np.int64)
    pass1 = build_tile_plan(index.block_members, member_block, cap, tm, ts,
                            headroom=headroom, group_min_tiles=floors,
                            torch_device=dev)
    owner_ids = np.asarray(index.link_owner_ids, np.int64)
    pass2 = build_tile_plan(index.link_block, owner_ids, index.n, tm, ts,
                            headroom=headroom, torch_device=dev)
    links = np.diff(index.link_owner_offsets).astype(np.float32)
    p1_ell, p2_ell = _ell_from_index(index, cap, dev)
    return DBIndexPlan(
        n=index.n,
        num_blocks=index.num_blocks,
        block_capacity=cap,
        pass1=pass1,
        pass2=pass2,
        block_sizes=upload(_block_sizes_padded(index, cap), dev, np.float32),
        link_counts=upload(links, dev, np.float32),
        device=dev,
        p1_ell=p1_ell,
        p2_ell=p2_ell,
    )


def patch_plan_dbindex(
    plan: DBIndexPlan, index: DBIndex, changed_owners: np.ndarray,
    compact_garbage: float = 0.5, headroom: float = 0.0,
) -> DBIndexPlan:
    """Incremental plan maintenance after ``update_dbindex_batch``.

    The merged index keeps the primary block prefix intact and appends
    secondary blocks, so pass 1 only re-lays-out the tile groups holding
    appended block ids; pass 2 re-lays-out the groups containing
    ``changed_owners`` (the batch's affected owner set).  Everything else
    is kept from the live plan; shape-stable patches write into the live
    tensors in place (see :func:`patch_tile_plan`; a caller that must keep
    the old plan patches its :meth:`DBIndexPlan.clone`).

    Delete-heavy streams accumulate *garbage blocks* — blocks no owner
    links to any more, whose member rows still occupy pass-1 tiles.  When
    the garbage fraction crosses ``compact_garbage``, pass 1 is re-laid-out
    without the garbage blocks' member rows (block ids are untouched, so
    pass 2 is unaffected beyond the shape change).

    When the updater fell back to a full rebuild (``last_full_rebuild``
    stat), the appended-prefix invariant does not hold and splicing would
    silently reuse stale tiles — build a fresh plan instead.
    """
    dev = plan.device
    cap = plan.block_capacity
    if index.num_blocks > cap:
        cap = _pow2(index.num_blocks)
    if index.stats.get("last_full_rebuild"):
        return plan_from_dbindex(index, plan.pass1.tm, plan.pass1.ts,
                                 block_capacity=cap, headroom=headroom,
                                 torch_device=dev)
    member_block = np.asarray(index.member_block_ids, np.int64)
    linked = index.linked_blocks_mask()
    # require actual garbage, not just fraction >= threshold: an empty or
    # garbage-free index with compact_garbage == 0.0 would otherwise take
    # the full pass-1 re-layout every batch (a spurious compaction that
    # drops nothing — the delete-everything / zero-block degenerate cases)
    has_garbage = index.num_blocks > 0 and bool(np.any(~linked))
    if has_garbage and index.garbage_block_fraction(linked) >= compact_garbage:
        keep = linked[member_block]
        pass1 = build_tile_plan(
            index.block_members[keep], member_block[keep], cap,
            plan.pass1.tm, plan.pass1.ts, headroom=headroom, torch_device=dev,
        )
    else:
        new_blocks = np.arange(plan.num_blocks, index.num_blocks, dtype=np.int64)
        pass1 = patch_tile_plan(
            plan.pass1,
            index.block_members,
            member_block,
            cap,
            new_blocks,
        )
    pass2 = patch_tile_plan(
        plan.pass2,
        index.link_block,
        np.asarray(index.link_owner_ids, np.int64),
        index.n,
        np.asarray(changed_owners, np.int64),
    )
    links = np.diff(index.link_owner_offsets).astype(np.float32)
    p1_ell, p2_ell = _patch_ell(plan, index, cap, changed_owners)
    return DBIndexPlan(
        n=index.n,
        num_blocks=index.num_blocks,
        block_capacity=cap,
        pass1=pass1,
        pass2=pass2,
        block_sizes=upload(_block_sizes_padded(index, cap), dev, np.float32),
        link_counts=upload(links, dev, np.float32),
        device=dev,
        p1_ell=p1_ell,
        p2_ell=p2_ell,
    )


def _ell_rows_for_new_blocks(index: DBIndex, old_num_blocks: int,
                             width: int) -> np.ndarray:
    """Padded ELL rows for the blocks appended past ``old_num_blocks``
    (relies on the appended-prefix invariant of phase-1 merges)."""
    off = index.block_offsets[old_num_blocks:]
    return _ell_rows(off - off[0], index.block_members[off[0]:],
                     off.size - 1, width)


def _ell_rows_for_owners(index: DBIndex, owners: np.ndarray,
                         width: int) -> np.ndarray:
    """Padded ELL rows of the given owners' link lists (vectorized
    multi-slice gather)."""
    counts = np.diff(index.link_owner_offsets)[owners]
    starts = index.link_owner_offsets[owners]
    off = np.zeros(owners.size + 1, np.int64)
    np.cumsum(counts, out=off[1:])
    items = index.link_block[
        np.repeat(starts, counts)
        + (np.arange(off[-1]) - np.repeat(off[:-1], counts))
    ]
    return _ell_rows(off, items, owners.size, width)


def _patch_ell(plan: DBIndexPlan, index: DBIndex, cap: int,
               changed_owners: np.ndarray):
    """Incremental maintenance of the min/max ELL layouts: write only the
    appended blocks' rows and the changed owners' rows, in place into the
    live tensors; rebuild (a shape change, like capacity growth) only when
    a row no longer fits its padded width."""
    if plan.p1_ell is None:
        return None, None
    dev = plan.device
    block_sizes = np.diff(index.block_offsets)
    new_sizes = block_sizes[plan.num_blocks:]
    link_sizes = np.diff(index.link_owner_offsets)
    owners = np.asarray(changed_owners, np.int64)
    r1, r2 = plan.p1_ell.shape[1], plan.p2_ell.shape[1]
    if (cap != plan.block_capacity
            or (new_sizes.size and int(new_sizes.max()) > r1)
            or (owners.size and int(link_sizes[owners].max()) > r2)):
        return _ell_from_index(index, cap, dev)
    if new_sizes.size:
        rows = _ell_rows_for_new_blocks(index, plan.num_blocks, r1)
        ids = torch.arange(plan.num_blocks, index.num_blocks, device=dev)
        plan.p1_ell.index_copy_(0, ids, upload(rows, dev))
    if owners.size:
        rows = _ell_rows_for_owners(index, owners, r2)
        plan.p2_ell.index_copy_(0, torch.from_numpy(owners).to(dev),
                                upload(rows, dev))
    return plan.p1_ell, plan.p2_ell


# ---------------------------------------------------------------------- #
#  Queries
# ---------------------------------------------------------------------- #
def _ell_reduce(ell: torch.Tensor, vec: torch.Tensor, op: str) -> torch.Tensor:
    """Dense padded reduce: one gather + axis reduce, no scatter.  ``vec``
    is ``[S, B]``; the sentinel pad index is clamped explicitly to the
    appended identity row ``S`` (torch indexing raises out of range where
    ``jnp.take`` clips)."""
    ident = float("inf") if op == "min" else float("-inf")
    ext = torch.cat([vec, torch.full((1, vec.shape[1]), ident,
                                     dtype=vec.dtype, device=vec.device)])
    rows = ext[ell.long().clamp_(max=vec.shape[0])]  # [R, width, B]
    return rows.amin(dim=1) if op == "min" else rows.amax(dim=1)


#: distinct (plan shape, aggregates, values shape, device) signatures the
#: executor has run — the port's analogue of the reference's jit cache
#: entries (see :func:`repro_torch.core.api.recompile_count`)
_SIGNATURES: set = set()


def signature_count() -> int:
    """Distinct plan shape signatures seen by the fused query executor."""
    return len(_SIGNATURES)


def _stacked_pass(tp: TilePlan, cols: dict, order: list, b: int,
                  monoid_of: dict) -> dict:
    """One K1 launch over the channels ``order`` (sum, then min, then max
    columns, ``b`` batch columns each): ``{channel: [S, b]}``."""
    if not order:
        return {}
    mat = torch.cat([cols[ci] for ci in order], dim=1)
    counts = tuple(b * sum(monoid_of[ci] == m for ci in order)
                   for m in ("sum", "min", "max"))
    red = segment_reduce_multi(tp, mat, counts)
    return {ci: red[:, j * b:(j + 1) * b] for j, ci in enumerate(order)}


def _query_dbindex_multi_channels(plan: DBIndexPlan, values: torch.Tensor,
                                  aggs: tuple):
    """Channel core of :func:`query_dbindex_multi` over a ``[n, B]`` float32
    column batch: returns the deduped monoid channels, each ``[n, B]``.

    Every channel of every batch column rides one K1 launch per pass, sum
    columns first, then min, then max: pass 1 stacks the value/square
    columns (the count channel reads the host-exact ``block_sizes`` and
    skips pass 1), pass 2 the ``[block_capacity, C·B]`` partial matrix.  A
    plan with ELL layouts takes min/max through them instead (one dense
    gather + axis reduce a pass).  K1 reduces each column in an order fixed
    by the plan whatever the column count, so a batch column equals the
    unbatched result bit for bit."""
    _SIGNATURES.add((plan.shape_signature(), aggs, tuple(values.shape),
                     str(plan.device)))
    pack = pack_channels(aggs)
    return dbindex_pass2(plan, dbindex_pass1(plan, values, pack), pack)


def _k1_channels(pack, ell: bool) -> tuple:
    """``(monoid_of, order)``: each channel's monoid, and the channels K1
    reduces in its column groups (sum, then min, then max; min/max only
    when the plan has no ELL layouts)."""
    monoid_of = {ci: m for ci, (m, _) in enumerate(pack.channels)}
    order = [ci for m in ("sum", "min", "max") for ci in monoid_of
             if monoid_of[ci] == m and (m == "sum" or not ell)]
    return monoid_of, order


def dbindex_pass1(plan: DBIndexPlan, values: torch.Tensor, pack) -> dict:
    """Pass 1 (members → block partials) of the fused DBIndex query over a
    ``[n, B]`` float32 column batch: one K1 launch over the stacked
    value/square columns, the gather fused in; ``{channel: [cap, B]}``."""
    b = values.shape[1]
    ell = plan.p1_ell is not None
    monoid_of, k1 = _k1_channels(pack, ell)
    squares = None

    def source(src: str) -> torch.Tensor:
        nonlocal squares
        if src == "value":
            return values
        if squares is None:
            squares = values * values
        return squares

    gathered = {ci: source(pack.channels[ci][1]) for ci in k1
                if pack.channels[ci] != ("sum", "ones")}
    t_cols = _stacked_pass(plan.pass1, gathered,
                           [ci for ci in k1 if ci in gathered], b, monoid_of)
    for ci in k1:
        if ci not in gathered:
            # block cardinalities are host-exact plan metadata
            t_cols[ci] = plan.block_sizes[:, None].expand(-1, b)
    if ell:
        for ci, (mname, src) in enumerate(pack.channels):
            if mname != "sum":
                t_cols[ci] = _ell_reduce(plan.p1_ell, source(src), mname)
    return t_cols


def dbindex_pass2(plan: DBIndexPlan, t_cols: dict, pack) -> tuple:
    """Pass 2 (block partials → owner windows): one K1 launch over the
    stacked partial matrix; with ELL layouts min/max take the dense gather
    (idempotent, order-insensitive).  Returns the channels, each
    ``[n, B]``."""
    b = next(iter(t_cols.values())).shape[1]
    ell = plan.p1_ell is not None
    monoid_of, k1 = _k1_channels(pack, ell)
    outs = _stacked_pass(plan.pass2, t_cols, k1, b, monoid_of)
    if ell:
        for ci, (mname, _) in enumerate(pack.channels):
            if mname != "sum":
                outs[ci] = _ell_reduce(plan.p2_ell, t_cols[ci], mname)
    return tuple(outs[ci] for ci in range(len(pack.channels)))


def _as_values(values, dev: torch.device) -> torch.Tensor:
    """Attribute values as float32 on ``dev`` (the reference casts before
    every reduce; the generators emit float64)."""
    if isinstance(values, torch.Tensor):
        return values.to(device=dev, dtype=torch.float32)
    return torch.from_numpy(np.asarray(values, np.float32)).to(dev)


def query_dbindex_multi(plan: DBIndexPlan, values, aggs: tuple):
    """Fused multi-aggregate DBIndex query over ``values`` ``[n]`` — or a
    ``[B, n]`` batch, folded into the channel columns so each pass is still
    one K1 launch.

    ``aggs`` names aggregates sharing one window; the channels are deduped
    (``sum``/``avg`` share the value channel, ``count``/``avg`` the
    cardinality channel, registered derived aggregates ride extra
    ``square`` channels).  Finalizers run eagerly on the channel results.
    Returns one float32 tensor per aggregate, in ``aggs`` order.
    """
    aggs = tuple(aggs)
    v = _as_values(values, plan.device)
    batched = v.dim() == 2
    cols = v.t().contiguous() if batched else v[:, None]
    chans = _query_dbindex_multi_channels(plan, cols, aggs)
    chans = tuple(c.t() if batched else c[:, 0] for c in chans)
    pack = pack_channels(aggs)
    return tuple(pack.finalize(i, chans, xp=TORCH_XP) for i in range(len(aggs)))


def query_dbindex(plan: DBIndexPlan, values, agg: str = "sum"):
    """values: [n] (or [n, D]) vertex attribute -> [n(, D)] window
    aggregates, one aggregate through the fused executor.

    ``[n, D]`` features ride K1's columns, as the reference's one-aggregate
    query takes them: each pass is still one K1 launch for all ``D``
    columns, and column ``j`` is bitwise the ``[n]`` query of ``X[:, j]``
    (K1's order is fixed by the plan).  Over ``[n, D]``, sum, min and max
    return ``[n, D]`` and count ``[n]``; avg raises, as the reference's
    ``[n, D] / [n]`` broadcast does."""
    v = _as_values(values, plan.device)
    if v.dim() == 1:
        return query_dbindex_multi(plan, v, (agg,))[0]
    if v.dim() != 2 or v.shape[0] != plan.n:
        raise ValueError(f"values must be [n] or [n, D] with n = {plan.n}, "
                         f"not {tuple(v.shape)}")
    if agg not in ("sum", "count", "min", "max"):
        raise ValueError(f"{agg!r} over [n, D] features: the reference's "
                         "one-aggregate query takes sum, count, min and max")
    cols = v[:, :1] if agg == "count" else v  # count reads no values
    chans = _query_dbindex_multi_channels(plan, cols.contiguous(), (agg,))
    out = pack_channels((agg,)).finalize(0, chans, xp=TORCH_XP)
    return out[:, 0] if agg == "count" else out


def query_dbindex_sharded_multi(plan: DBIndexPlan, values, aggs: tuple,
                                mesh, axis="data", torch_device=None):
    """Fused multi-aggregate distributed query (stacked-channel matrix
    form), SPMD: every rank of ``mesh`` calls it with the same plan and
    values and gets every aggregate.

    Tile rows are sharded over ``axis`` at whole-tile-group granularity
    (:mod:`repro_torch.distributed.window_runtime`), so every segment's
    partial is produced by exactly one shard: each pass is one K1 launch
    per shard, then one ``all_reduce`` per monoid, and every aggregate is
    **bit-identical** to :func:`query_dbindex_multi`'s (non-owning shards
    only ever contribute exact monoid identities).

    One-shot convenience — lays the plan out and uploads this rank's shard
    (to ``torch_device``, default the plan's device) per call.  Streaming
    callers hold a :class:`~repro_torch.distributed.window_runtime.ShardedDBPlan`
    (via ``Session(mesh=...)``), so the layout uploads once."""
    from repro_torch.distributed.window_runtime import (
        build_sharded_plan,
        query_sharded_multi,
    )

    splan = build_sharded_plan(plan, mesh, axis, torch_device=torch_device)
    return query_sharded_multi(splan, values, tuple(aggs))


def query_dbindex_sharded(plan: DBIndexPlan, values, mesh, axis="data",
                          torch_device=None):
    """Single-aggregate (SUM) wrapper over the stacked-channel sharded
    query."""
    return query_dbindex_sharded_multi(plan, values, ("sum",), mesh, axis,
                                       torch_device)[0][: plan.n]


# ---------------------------------------------------------------------- #
#  I-Index plan
# ---------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class IIndexPlan:
    """Device plan of an I-Index: the window differences as one K1 tile
    plan (members → owners) and the PID forest in the scan's two layouts
    (``forest``: the level layout the plain scan walks, the chain layout the
    kernel walks).  Every tensor's shape depends on ``n`` alone except
    ``wd_plan``'s; the forest's ``max_level`` and chain count are data,
    handed to the scan as scalars, so a patch that deepens or re-cuts the
    forest changes no shape."""

    n: int
    wd_plan: TilePlan  # wd members -> per-vertex difference partials
    forest: Forest  # i32 [n] / [n + 1] tensors: pid, its level and chain layouts
    level: torch.Tensor  # i32 [n]
    wd_sizes: torch.Tensor  # f32 [n], |WD(v)|: the count channel's partials
    device: torch.device

    @property
    def pid(self) -> torch.Tensor:  # i32 [n], -1 roots
        return self.forest.pid

    @property
    def max_level(self) -> int:
        return self.forest.max_level

    def _arrays(self) -> dict:
        names = ("pid", "order", "level_ptr", "chains.vertices", "chains.ptr",
                 "chains.head_parent")
        return {**dict(zip(names, self.forest.arrays())), "level": self.level,
                "wd_sizes": self.wd_sizes}

    def named_arrays(self) -> dict:
        """The plan's tensors by name, the forest's and the chain layout's
        included (see :meth:`DBIndexPlan.named_arrays`)."""
        out = {f"wd_plan.{k}": t for k, t in self.wd_plan.named_arrays().items()}
        out.update(self._arrays())
        return out

    def array_nbytes(self) -> dict:
        """Exact per-array device bytes (see :meth:`DBIndexPlan.array_nbytes`)."""
        return {k: _nbytes(t) for k, t in self.named_arrays().items()}

    def clone(self) -> "IIndexPlan":
        """The same plan in fresh storage (see :meth:`DBIndexPlan.clone`)."""
        return dataclasses.replace(self, wd_plan=self.wd_plan.clone(),
                                   forest=self.forest.clone(), level=self.level.clone(),
                                   wd_sizes=self.wd_sizes.clone())

    def plan_nbytes(self) -> int:
        """Total device bytes held by this plan."""
        return sum(self.array_nbytes().values())

    def shape_signature(self) -> tuple:
        """Every tensor shape of the plan (``max_level`` and the chain count
        are data, not shape)."""
        tensors = (self.wd_plan.gather_padded, self.wd_plan.seg_tiles,
                   *self._arrays().values())
        return tuple(tuple(t.shape) for t in tensors)


def _wd_rows(index: IIndex):
    """(sizes, owner) of the flat WD arrays: each member row's owner."""
    sizes = np.diff(index.wd_offsets)
    return sizes, np.repeat(np.arange(index.n, dtype=np.int64), sizes)


def iindex_plan(n: int, wd_plan: TilePlan, pid, level, wd_sizes,
                dev: torch.device) -> IIndexPlan:
    """An :class:`IIndexPlan` on ``dev`` around ``wd_plan``, its forest
    laid out from ``pid`` and ``level``."""
    return IIndexPlan(n=n, wd_plan=wd_plan,
                      forest=forest_layout(pid, level).map(lambda a: upload(a, dev)),
                      level=upload(level, dev), wd_sizes=upload(wd_sizes, dev, np.float32),
                      device=dev)


def plan_from_iindex(index: IIndex, tm: int = 512, ts: int = 512,
                     torch_device="cuda") -> IIndexPlan:
    dev = resolve_device(torch_device)
    sizes, owner = _wd_rows(index)
    wd_plan = build_tile_plan(index.wd_members, owner, index.n, tm, ts, torch_device=dev)
    return iindex_plan(index.n, wd_plan, index.pid, index.level, sizes, dev)


def patch_plan_iindex(plan: IIndexPlan, index: IIndex,
                      changed_owners: np.ndarray) -> IIndexPlan:
    """Incremental plan maintenance after ``update_iindex_batch``: only the
    WD tile groups holding cone vertices are re-laid-out (in place when
    their shapes hold, see :func:`patch_tile_plan`); the PID forest, its
    level and chain layouts and the WD sizes are ``[n]`` arrays whose
    shapes never change, written into the live tensors in place."""
    dev = plan.device
    sizes, owner = _wd_rows(index)
    wd_plan = patch_tile_plan(plan.wd_plan, index.wd_members, owner, index.n,
                              np.asarray(changed_owners, np.int64))
    fresh = forest_layout(index.pid, index.level)
    for live, a in zip(plan.forest.arrays(), fresh.arrays()):
        live.copy_(upload(a, dev))
    plan.level.copy_(upload(index.level, dev))
    plan.wd_sizes.copy_(upload(sizes, dev, np.float32))
    forest = plan.forest._replace(max_level=fresh.max_level,
                                  chains=plan.forest.chains._replace(count=fresh.chains.count))
    return dataclasses.replace(plan, wd_plan=wd_plan, forest=forest)


def _query_iindex_multi_channels(plan: IIndexPlan, values: torch.Tensor,
                                 aggs: tuple, schedule: str = "level"):
    """Channel core of :func:`query_iindex_multi` over a ``[n, B]`` float32
    column batch: returns the deduped monoid channels, each ``[n, B]``.

    One K1 launch on ``wd_plan`` carries every channel's window-difference
    partials (the value and square columns: sum, then min, then max; the
    count channel reads the host-exact ``wd_sizes`` and skips it), then one
    inheritance-scan launch carries every column again, each with its
    monoid (the level schedule, walked along the plan's chains on the card;
    the doubling schedule is plain PyTorch)."""
    _SIGNATURES.add((plan.shape_signature(), aggs, tuple(values.shape),
                     str(plan.device), schedule))
    pack = pack_channels(aggs)
    return iindex_inherit(plan, iindex_wd_reduce(plan, values, pack), pack, schedule)


def iindex_wd_reduce(plan: IIndexPlan, values: torch.Tensor, pack) -> torch.Tensor:
    """The window-difference partials of every channel of a ``[n, B]``
    float32 column batch, stacked ``[n, C·B]`` by monoid (sum, then min,
    then max): one K1 launch on ``wd_plan``, the gather fused in."""
    b = values.shape[1]
    monoid_of, by_monoid = _k1_channels(pack, ell=False)
    srcs = {"value": values}
    if any(src == "square" for _, src in pack.channels):
        srcs["square"] = values * values
    gathered = {ci: srcs[pack.channels[ci][1]] for ci in by_monoid
                if pack.channels[ci] != ("sum", "ones")}
    wdp = _stacked_pass(plan.wd_plan, gathered,
                        [ci for ci in by_monoid if ci in gathered], b, monoid_of)
    for ci in by_monoid:
        if ci not in gathered:  # window-difference sizes are host-exact
            wdp[ci] = plan.wd_sizes[:, None].expand(-1, b)
    return torch.cat([wdp[ci] for ci in by_monoid], dim=1)


def iindex_inherit(plan: IIndexPlan, mat: torch.Tensor, pack,
                   schedule: str = "level") -> tuple:
    """Inheritance along the PID forest of :func:`iindex_wd_reduce`'s
    matrix: one scan launch over every column, each with its monoid.
    Returns the channels, each ``[n, B]``."""
    monoid_of, by_monoid = _k1_channels(pack, ell=False)
    b = mat.shape[1] // len(by_monoid)
    counts = tuple(b * sum(monoid_of[ci] == m for ci in by_monoid)
                   for m in ("sum", "min", "max"))
    done = inherit(mat, plan.forest, counts, schedule)
    out = {ci: done[:, j * b:(j + 1) * b] for j, ci in enumerate(by_monoid)}
    return tuple(out[ci] for ci in range(len(pack.channels)))


def query_iindex_multi(plan: IIndexPlan, values, aggs: tuple,
                       schedule: str = "level"):
    """Fused multi-aggregate topological query via inheritance, over
    ``values`` ``[n]`` or a ``[B, n]`` batch folded into the columns: one
    K1 launch and one scan launch whatever the aggregates and ``B``.
    min/max ride the per-monoid inheritance: containment (Theorem 5.1)
    makes the parent's finished aggregate a valid partial for any monoid.
    Finalizers run eagerly on the channel results.  Returns one float32
    tensor per aggregate, in ``aggs`` order."""
    aggs = tuple(aggs)
    v = _as_values(values, plan.device)
    batched = v.dim() == 2
    cols = v.t().contiguous() if batched else v[:, None]
    chans = _query_iindex_multi_channels(plan, cols, aggs, schedule)
    chans = tuple(c.t() if batched else c[:, 0] for c in chans)
    pack = pack_channels(aggs)
    return tuple(pack.finalize(i, chans, xp=TORCH_XP) for i in range(len(aggs)))


def query_iindex(plan: IIndexPlan, values, agg: str = "sum", *,
                 schedule: str = "level"):
    """values: [n] vertex attribute -> [n] topological window aggregates
    (one aggregate through the fused executor)."""
    return query_iindex_multi(plan, values, (agg,), schedule)[0]

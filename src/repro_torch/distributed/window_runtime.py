"""Sharded streaming runtime over ``torch.distributed``: distributed window
queries and update propagation.

The model is SPMD, PyTorch's own: every rank of a
:class:`~torch.distributed.device_mesh.DeviceMesh` constructs the same
:class:`ShardedSession`, holds the replicated host state (graph, DBIndex,
the plan's routing metadata) and keeps on its device **only its own
shard** of each plan; every rank calls ``run`` / ``run_many`` / ``update``
in the same order and gets the full, replicated result.

* :class:`ShardedDBPlan` — a DBIndex device plan laid out as *per-shard
  tile groups*.  The single-host plan already groups rows (members →
  blocks links, links → owners) by output tile group; here whole groups
  are assigned to shards (greedy balance over padded rows), so no segment
  ever straddles a shard.  That alignment is what buys **bit-identity**
  with the single-host fused path: each segment's partial is produced by
  exactly one shard in the same row order, and the cross-shard
  ``all_reduce`` only ever adds exact zeros (MIN / MAX exact identities)
  from the non-owning shards.  The canonical layout (the flat ``[ndev *
  rows]`` arrays) is host metadata on every rank: the digest, the wire and
  EXPLAIN read it.  A rank's device holds its span of those rows with the
  span's tile groups renumbered locally in offset order (a K1 tile plan of
  its own: non-decreasing output tiles, every one with an input tile).

* :func:`query_sharded_multi` — the stacked-channel matrix form: each
  pass is **one K1 launch** over the shard's rows (the gather fused in,
  sum / min / max columns together), its partials copied into an
  identity-filled ``[segments, C]`` matrix, then one ``all_reduce(SUM)``
  for the sum channels and one ``all_reduce(MIN)`` / ``(MAX)`` for the
  min / max channels.  With ELL layouts, min / max take a dense gather +
  axis reduce over the shard's contiguous id chunk instead.  A NaN in a
  min / max channel survives the combine: its count rides the SUM
  payload and NaN is restored where it is non-zero (a bare MIN / MAX
  all_reduce drops a NaN that a later rank holds).
  :func:`query_sharded_many` takes a whole ``[B, n]`` ``run_many`` bucket
  through the same launches (K1's batch columns).

* :func:`patch_sharded_plan` — streamed update propagation.  The changed
  tile groups are the wire format: after a batched index update only the
  groups holding appended secondary blocks (pass 1) and the affected
  owners' link groups (pass 2) are re-laid-out, written into the host
  layout and, on the rank that owns them, into its device shard in place
  (``index_copy_``); shapes never change in steady state.
  :func:`encode_wire_message` / :func:`apply_wire_message` replay the same
  patches on a follower, checked against the leader's ``plan_crc``.

* :class:`ShardedSession` — ``Session(mesh=...)``: per-shard plans, the
  affected-owner BFS sharded over the data axis (each rank traverses only
  its slice of the batch's touched endpoints, then one ``all_reduce``
  unions the owner masks), batches streamed with no new plan signature,
  ``run`` / ``run_many`` served across the mesh.

A CPU mesh runs on gloo; a mesh of cards on NCCL (or on gloo, which takes
CUDA tensors for ``all_reduce`` and ``broadcast``, the only collectives
used here).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs as _obs
from repro_torch.core import engine_torch as et
from repro_torch.core.aggregates import TORCH_XP, pack_channels
from repro_torch.core.dbindex import DBIndex
from repro_torch.core.graph import Graph
from repro_torch.core.streaming import StalenessPolicy, StreamingEngine
from repro_torch.core.updates import (
    UpdateBatch,
    spmd_affected_owners,
    update_dbindex_batch,
)
from repro_torch.device import resolve_device, upload
from repro_torch.kernels.segment_reduce.ops import TilePlan, _nbytes, _plan

_IDENTITY = {"sum": 0.0, "min": float("inf"), "max": float("-inf")}


def _axes_tuple(axis) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _mesh_shard(mesh, axes: Tuple[str, ...]):
    """``(ndev, shard, group)`` of this rank over the mesh dimensions
    ``axes``: the shard count, this rank's shard (its coordinates over
    ``axes``, row-major in the order given) and the process group the
    combine runs over."""
    names = tuple(mesh.mesh_dim_names or ())
    missing = [a for a in axes if a not in names]
    if missing:
        raise ValueError(f"mesh has no dimension {missing} (dims {names})")
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not part of the mesh")
    ndev, shard = 1, 0
    for a in axes:
        d = names.index(a)
        ndev *= mesh.size(d)
        shard = shard * mesh.size(d) + int(coord[d])
    if len(axes) == 1:
        return ndev, shard, mesh.get_group(axes[0])
    # several dimensions: the group of their flattened sub-mesh (the mesh
    # keeps it, so a rebuild finds the same group)
    return ndev, shard, mesh[axes]._flatten().get_group()


def _host(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ---------------------------------------------------------------------- #
#  Shard-aligned plan layout
# ---------------------------------------------------------------------- #
def _group_layout(tile_plan) -> Tuple[np.ndarray, np.ndarray]:
    """(tiles_per_group, flat row starts) of a group-aligned tile layout."""
    m2out = _host(tile_plan.m2out)
    tiles = np.bincount(m2out, minlength=tile_plan.num_out_tiles).astype(np.int64)
    starts = np.zeros(tile_plan.num_out_tiles + 1, np.int64)
    np.cumsum(tiles * tile_plan.tm, out=starts[1:])
    return tiles, starts


def _assign_groups(rows_per_group: np.ndarray, ndev: int):
    """Greedy balanced assignment of whole tile groups to shards.

    Groups are placed largest-first on the least-loaded shard (first shard
    wins ties) — deterministic, and within ~1 group of optimal for the
    near-uniform group sizes the headroom-floored layouts produce.  Returns
    ``(shard_of_group, offset_in_shard, rows_per_shard)``; every shard's row
    span is padded to the max load so every shard has equal shapes.
    """
    order = np.argsort(-rows_per_group, kind="stable")
    shard_of = np.zeros(rows_per_group.size, np.int64)
    offset = np.zeros(rows_per_group.size, np.int64)
    load = np.zeros(ndev, np.int64)
    for g in order:
        s = int(np.argmin(load))
        shard_of[g] = s
        offset[g] = load[s]
        load[s] += rows_per_group[g]
    return shard_of, offset, max(int(load.max()), 1)


def _pack_shards(src_seg, src_gather, starts, rows_per_group, shard_of, offset,
                 rows_cap: int, ndev: int):
    """Scatter group row spans into equal per-shard flat arrays (pad -1/0)."""
    seg = np.full(ndev * rows_cap, -1, np.int32)
    gather = np.zeros(ndev * rows_cap, np.int32)
    for g in range(rows_per_group.size):
        span = int(rows_per_group[g])
        if span == 0:
            continue
        lo = int(shard_of[g]) * rows_cap + int(offset[g])
        s0 = int(starts[g])
        seg[lo : lo + span] = src_seg[s0 : s0 + span]
        gather[lo : lo + span] = src_gather[s0 : s0 + span]
    return seg, gather


def _ell_shards(rows_np: np.ndarray, num_ids: int, ndev: int):
    """Pad an [num_ids, R] ELL matrix to equal contiguous id chunks."""
    per = max(-(-num_ids // ndev), 1)
    pad = per * ndev - num_ids
    if pad:
        rows_np = np.concatenate(
            [rows_np, np.full((pad, rows_np.shape[1]), et._ELL_SENTINEL, np.int32)]
        )
    ids = np.full(per * ndev, -1, np.int32)
    ids[:num_ids] = np.arange(num_ids, dtype=np.int32)
    return rows_np, ids


@dataclasses.dataclass(frozen=True)
class ShardPass:
    """One pass of this rank's shard on its device: the K1 tile plan of the
    shard's rows (``tiles``: the canonical span's gather indices, its
    segment ids renumbered to local output tiles in offset order, padding
    past the last group in a sink tile) and the map back to the canonical
    segment space (``groups``: the global output tile of each local one)."""

    tiles: TilePlan
    groups: torch.Tensor  # int64 [n_local]
    local_of: np.ndarray  # host int64 [num_out_tiles]: local tile of a group, -1 off-shard
    num_out_tiles: int  # of the canonical segment space

    def to_local(self, seg: np.ndarray) -> np.ndarray:
        """Canonical segment ids (``-1`` on pad rows) as this shard's local ids."""
        return _local_ids(self.local_of, seg, self.tiles.ts)

    def device_arrays(self) -> Dict[str, torch.Tensor]:
        return {"gather": self.tiles.gather_padded, "seg": self.tiles.seg_tiles,
                "m2out": self.tiles.m2out, "first_visit": self.tiles.first_visit,
                "groups": self.groups}

    def clone(self) -> "ShardPass":
        return dataclasses.replace(self, tiles=self.tiles.clone(),
                                   groups=self.groups.clone())


def _local_ids(local_of: np.ndarray, seg: np.ndarray, ts: int) -> np.ndarray:
    return np.where(seg >= 0, local_of[np.maximum(seg, 0) // ts] * ts + seg % ts,
                    -1).astype(np.int32)


def _shard_pass(seg_flat, gather_flat, shard_of, offset, tiles, rows_cap: int,
                shard: int, tm: int, ts: int, dev) -> ShardPass:
    mine = np.flatnonzero(shard_of == shard)
    mine = mine[np.argsort(offset[mine], kind="stable")]
    local_of = np.full(tiles.size, -1, np.int64)
    local_of[mine] = np.arange(mine.size)
    tail = (rows_cap - int(tiles[mine].sum()) * tm) // tm
    m2out = np.concatenate([np.repeat(np.arange(mine.size, dtype=np.int32), tiles[mine]),
                            np.full(tail, mine.size, np.int32)])
    lo = shard * rows_cap
    seg = _local_ids(local_of, seg_flat[lo : lo + rows_cap], ts)
    tp = _plan(gather_flat[lo : lo + rows_cap], seg.reshape(-1, tm), m2out,
               mine.size * ts, mine.size + (1 if tail else 0), tm, ts, dev)
    return ShardPass(tiles=tp, groups=torch.from_numpy(mine.astype(np.int64)).to(dev),
                     local_of=local_of, num_out_tiles=int(tiles.size))


@dataclasses.dataclass(frozen=True)
class ShardedDBPlan:
    """This rank's DBIndex plan shard plus the host metadata needed to
    route tile-group patches to the shard that owns them.

    Tile rows (pass 1/2) are sharded at whole-group granularity by the
    greedy assignment; ELL rows are sharded by contiguous id chunks (block
    ids for pass 1, owner ids for pass 2), so a shard's reduce lands in a
    slice of an identity-filled full vector before the MIN / MAX combine.

    ``flat`` holds the canonical layout on the host, the same on every
    rank: the reference's flat ``[ndev * rows]`` arrays under its keys
    (:meth:`named_arrays`, what the digest folds).  The device holds this
    rank's shard only (:meth:`array_nbytes`)."""

    mesh: object
    axes: Tuple[str, ...]
    ndev: int
    shard: int
    group: object  # the process group of the combine
    device: torch.device
    n: int
    num_blocks: int
    block_capacity: int
    tm: int
    ts: int
    headroom: float
    nb_seg: int  # padded pass-1 segment space (num_out_tiles1 * ts)
    n_seg: int  # padded pass-2 segment space (num_out_tiles2 * ts)
    rows1: int  # per-shard pass-1 rows
    rows2: int  # per-shard pass-2 rows
    pass1: ShardPass
    pass2: ShardPass
    block_sizes: torch.Tensor  # f32 [block_capacity], replicated
    flat: Dict[str, np.ndarray]
    e1: Optional[torch.Tensor] = None  # i32 [ell_rows1, R1]: this shard's block ids
    e2: Optional[torch.Tensor] = None  # i32 [ell_rows2, R2]: this shard's owner ids
    # host metadata (patch routing)
    group_shard1: Optional[np.ndarray] = None
    group_off1: Optional[np.ndarray] = None
    group_tiles1: Optional[np.ndarray] = None
    group_shard2: Optional[np.ndarray] = None
    group_off2: Optional[np.ndarray] = None
    group_tiles2: Optional[np.ndarray] = None
    stats: Dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def has_ell(self) -> bool:
        return self.e1 is not None

    def named_arrays(self) -> Dict[str, np.ndarray]:
        """The whole canonical layout under the reference's keys (host
        NumPy, identical on every rank): what the digest folds, so a
        plan's ``plan_crc`` equals the reference's for the same plan and
        shard count."""
        return dict(self.flat)

    def device_arrays(self) -> Dict[str, torch.Tensor]:
        """This rank's device tensors: its shard of each pass (the K1
        tile plan and the local-to-global tile map), the replicated block
        sizes and its ELL id chunks."""
        out = {f"p{i}_{k}": t for i, sp in ((1, self.pass1), (2, self.pass2))
               for k, t in sp.device_arrays().items()}
        out["block_sizes"] = self.block_sizes
        if self.has_ell:
            out["e1"], out["e2"] = self.e1, self.e2
        return out

    def array_nbytes(self) -> Dict:
        """Exact per-array device bytes on this rank (its shard only)."""
        return {k: _nbytes(t) for k, t in self.device_arrays().items()}

    def plan_nbytes(self) -> int:
        """Total device bytes this rank holds for the plan."""
        return sum(self.array_nbytes().values())

    def size_bytes(self) -> int:
        """Bytes of the whole canonical plan across every shard — what a
        full re-upload ships (the reference's ``size_bytes``)."""
        return sum(int(a.nbytes) for a in self.flat.values())

    def shape_signature(self) -> tuple:
        """Every tensor shape of this rank's shard, and the shard count."""
        return (self.ndev,) + tuple(tuple(t.shape) for t in self.device_arrays().values())

    def clone(self) -> "ShardedDBPlan":
        """The same plan in fresh storage (this rank's device shard and the
        host layout): a patch of the clone leaves this plan as it is."""
        return dataclasses.replace(
            self, pass1=self.pass1.clone(), pass2=self.pass2.clone(),
            block_sizes=self.block_sizes.clone(),
            flat={k: a.copy() for k, a in self.flat.items()},
            e1=None if self.e1 is None else self.e1.clone(),
            e2=None if self.e2 is None else self.e2.clone(),
            stats=dict(self.stats))

    def shard_row_loads(self) -> Dict:
        """Per-shard real (unpadded) row loads for both passes, from the
        patch-routing metadata — EXPLAIN's shard-balance view."""
        out: Dict = {}
        for name, shard_of, tiles, rows_cap in (
            ("pass1", self.group_shard1, self.group_tiles1, self.rows1),
            ("pass2", self.group_shard2, self.group_tiles2, self.rows2),
        ):
            if shard_of is None or tiles is None:
                continue
            loads = np.zeros(self.ndev, np.int64)
            np.add.at(loads, np.asarray(shard_of, np.int64),
                      np.asarray(tiles, np.int64) * self.tm)
            out[name] = {
                "rows_per_shard": [int(x) for x in loads],
                "rows_capacity": int(rows_cap),
                "balance": (float(loads.min() / loads.max())
                            if loads.max() else 1.0),
            }
        return out

    def reducing_shard(self, ids, pass_id: int) -> np.ndarray:
        """The shard that reduces each block id (``pass_id`` 1) or owner id
        (2): the one holding its ELL id chunk, or its tile group."""
        ids = np.asarray(ids, np.int64)
        if self.has_ell:
            return ids // (self.e1 if pass_id == 1 else self.e2).shape[0]
        return (self.group_shard1 if pass_id == 1 else self.group_shard2)[ids // self.ts]


def build_sharded_plan(plan, mesh, axis="data", headroom: float = 0.0,
                       stats: Optional[Dict] = None,
                       torch_device=None) -> ShardedDBPlan:
    """Lay a single-host :class:`~repro_torch.core.engine_torch.DBIndexPlan`
    (on any device; the CPU keeps the whole plan off the card) out as
    shards and upload this rank's to ``torch_device`` (default: the plan's
    device).  ``headroom`` is recorded so rebuilds keep the same streaming
    slack; ``stats`` carries counters forward across rebuilds."""
    axes = _axes_tuple(axis)
    ndev, shard, group = _mesh_shard(mesh, axes)
    dev = resolve_device(plan.device if torch_device is None else torch_device)
    tm, ts = plan.pass1.tm, plan.pass1.ts

    tiles1, starts1 = _group_layout(plan.pass1)
    tiles2, starts2 = _group_layout(plan.pass2)
    rows_g1, rows_g2 = tiles1 * tm, tiles2 * plan.pass2.tm
    shard1, off1, rows1 = _assign_groups(rows_g1, ndev)
    shard2, off2, rows2 = _assign_groups(rows_g2, ndev)
    p1_seg, p1_gather = _pack_shards(
        _host(plan.pass1.seg_tiles).reshape(-1), _host(plan.pass1.gather_padded),
        starts1, rows_g1, shard1, off1, rows1, ndev)
    p2_seg, p2_gather = _pack_shards(
        _host(plan.pass2.seg_tiles).reshape(-1), _host(plan.pass2.gather_padded),
        starts2, rows_g2, shard2, off2, rows2, ndev)
    sizes = np.asarray(_host(plan.block_sizes), np.float32)
    flat = {"p1_gather": p1_gather, "p1_seg": p1_seg, "p2_gather": p2_gather,
            "p2_seg": p2_seg, "block_sizes": sizes}
    e1 = e2 = None
    if plan.p1_ell is not None:
        flat["e1"], flat["e1_ids"] = _ell_shards(_host(plan.p1_ell), plan.block_capacity, ndev)
        flat["e2"], flat["e2_ids"] = _ell_shards(_host(plan.p2_ell), plan.n, ndev)
        e1, e2 = (upload(_chunk(flat[k], ndev, shard), dev) for k in ("e1", "e2"))
    base_stats = dict(stats or {})
    base_stats.setdefault("patched_bytes_total", 0)
    base_stats.setdefault("rebuilds", 0)
    base_stats.setdefault("version", 0)
    # a fresh layout lays out every member row the index holds — any
    # previously compacted garbage rows are back, so the ledger the
    # patcher keeps must restart empty
    base_stats.pop("p1_compacted_ids", None)
    splan = ShardedDBPlan(
        mesh=mesh, axes=axes, ndev=ndev, shard=shard, group=group, device=dev,
        n=plan.n, num_blocks=plan.num_blocks, block_capacity=plan.block_capacity,
        tm=tm, ts=ts, headroom=headroom,
        nb_seg=plan.pass1.num_out_tiles * ts, n_seg=plan.pass2.num_out_tiles * plan.pass2.ts,
        rows1=rows1, rows2=rows2,
        pass1=_shard_pass(p1_seg, p1_gather, shard1, off1, tiles1, rows1, shard, tm, ts, dev),
        pass2=_shard_pass(p2_seg, p2_gather, shard2, off2, tiles2, rows2, shard, tm, ts, dev),
        block_sizes=upload(sizes, dev, np.float32), flat=flat, e1=e1, e2=e2,
        group_shard1=shard1, group_off1=off1, group_tiles1=tiles1,
        group_shard2=shard2, group_off2=off2, group_tiles2=tiles2,
        stats=base_stats,
    )
    base_stats["full_bytes"] = splan.size_bytes()
    return splan


def _chunk(a: np.ndarray, ndev: int, shard: int) -> np.ndarray:
    per = a.shape[0] // ndev
    return a[shard * per : (shard + 1) * per]


# ---------------------------------------------------------------------- #
#  Sharded fused multi-aggregate query
# ---------------------------------------------------------------------- #
def _combine(group, parts: Dict[str, List], b: int) -> list:
    """The cross-shard combine of one pass over ``group``: ``parts[m]``
    lists this shard's identity-filled ``[size, b]`` partials of the
    channels of monoid ``m``.  One ``all_reduce`` per monoid present; the
    min/max channels' NaN counts ride the SUM payload, and NaN is put back
    where a count is non-zero.  Returns the combined partials in the
    order given (sum, then min, then max)."""
    sums, idem = parts["sum"], parts["min"] + parts["max"]
    payload = sums + [torch.isnan(p).to(torch.float32) for p in idem]
    if not payload:
        return []
    red = torch.cat(payload, dim=1)
    dist.all_reduce(red, op=dist.ReduceOp.SUM, group=group)
    cols = red.split(b, dim=1)
    out, nans = list(cols[: len(sums)]), iter(cols[len(sums):])
    for m, op in (("min", dist.ReduceOp.MIN), ("max", dist.ReduceOp.MAX)):
        if parts[m]:
            red = torch.cat(parts[m], dim=1)
            dist.all_reduce(red, op=op, group=group)
            out += [torch.where(next(nans) > 0, torch.nan, col) for col in red.split(b, dim=1)]
    return out


def _place_k1(sp: ShardPass, local: torch.Tensor, counts: Tuple[int, int, int],
              size: int) -> torch.Tensor:
    """This shard's K1 output ``[n_local * ts, C]`` (``counts`` sum, min
    and max columns, in that order) in an identity-filled ``[size, C]``
    matrix of the canonical segment space."""
    c, ts = local.shape[1], sp.tiles.ts
    full = torch.empty((sp.num_out_tiles * ts, c), dtype=torch.float32, device=local.device)
    lo = 0
    for m, k in zip(("sum", "min", "max"), counts):
        full[:, lo:lo + k].fill_(_IDENTITY[m])
        lo += k
    if local.shape[0]:
        full.view(sp.num_out_tiles, ts, c).index_copy_(
            0, sp.groups, local.view(-1, ts, c))
    return full[:size]


def _place_chunk(chunk: torch.Tensor, lo: int, size: int, ident: float) -> torch.Tensor:
    """An ELL reduce over ids ``[lo, lo + len(chunk))`` in an
    identity-filled ``[size, B]`` vector (ids past ``size`` are padding)."""
    full = torch.full((size, chunk.shape[1]), ident, dtype=torch.float32,
                      device=chunk.device)
    hi = min(lo + chunk.shape[0], size)
    if hi > lo:
        full[lo:hi] = chunk[: hi - lo]
    return full


def _sharded_pass(splan: ShardedDBPlan, sp: ShardPass, ell, srcs: Dict, order: List,
                  monoid_of: Dict, b: int, size: int, ell_srcs: Dict) -> Dict:
    """One pass on this shard then across the mesh: one K1 launch over
    ``srcs``' channels in ``order`` (sum, then min, then max columns),
    the ELL reduce of ``ell_srcs``' min/max channels over the shard's id
    chunk, then :func:`_combine`.  Returns ``{channel: [size, b]}``."""
    parts = {"sum": [], "min": [], "max": []}
    chans = {"sum": [], "min": [], "max": []}
    if order:
        mat = torch.cat([srcs[ci] for ci in order], dim=1)
        counts = tuple(b * sum(monoid_of[ci] == m for ci in order)
                       for m in ("sum", "min", "max"))
        local = et.segment_reduce_multi(sp.tiles, mat, counts)
        full = _place_k1(sp, local, counts, size)
        for j, ci in enumerate(order):
            parts[monoid_of[ci]].append(full[:, j * b:(j + 1) * b])
            chans[monoid_of[ci]].append(ci)
    for ci, vec in ell_srcs.items():
        m = monoid_of[ci]
        red = et._ell_reduce(ell, vec, m)
        parts[m].append(_place_chunk(red, splan.shard * ell.shape[0], size, _IDENTITY[m]))
        chans[m].append(ci)
    done = _combine(splan.group, parts, b)
    return dict(zip(chans["sum"] + chans["min"] + chans["max"], done))


def _sharded_channels(splan: ShardedDBPlan, values: torch.Tensor, aggs: tuple):
    """Channel core of :func:`query_sharded_multi` over a ``[n, B]``
    float32 column batch: the deduped monoid channels, each ``[n, B]``,
    the same on every rank."""
    et._SIGNATURES.add((splan.shape_signature(), aggs, tuple(values.shape),
                        str(splan.device), "sharded"))
    pack = pack_channels(aggs)
    b = values.shape[1]
    monoid_of, k1 = et._k1_channels(pack, splan.has_ell)
    idem = [ci for ci, (m, _) in enumerate(pack.channels) if m != "sum"]
    squares = None

    def source(src: str) -> torch.Tensor:
        nonlocal squares
        if src == "value":
            return values
        if squares is None:
            squares = values * values
        return squares

    # ---- pass 1: members -> block partials (count: host-exact sizes) ---
    gathered = {ci: source(pack.channels[ci][1]) for ci in k1
                if pack.channels[ci] != ("sum", "ones")}
    ell1 = ({ci: source(pack.channels[ci][1]) for ci in idem} if splan.has_ell else {})
    t_cols = _sharded_pass(splan, splan.pass1, splan.e1, gathered,
                           [ci for ci in k1 if ci in gathered], monoid_of, b,
                           splan.block_capacity, ell1)
    for ci in k1:
        if ci not in gathered:
            t_cols[ci] = splan.block_sizes[:, None].expand(-1, b)
    # ---- pass 2: block partials -> owner windows ------------------------
    ell2 = {ci: t_cols[ci] for ci in idem} if splan.has_ell else {}
    outs = _sharded_pass(splan, splan.pass2, splan.e2, t_cols, k1, monoid_of, b,
                         splan.n, ell2)
    return tuple(outs[ci] for ci in range(len(pack.channels)))


def sharded_signature_count() -> int:
    """Distinct plan shape signatures the sharded query has run (the
    sharded share of :func:`repro_torch.core.engine_torch.signature_count`)."""
    return sum(1 for sig in et._SIGNATURES if sig[-1] == "sharded")


def _query(splan: ShardedDBPlan, values, aggs: tuple, batched: bool):
    v = et._as_values(values, splan.device)
    if batched and v.dim() != 2:
        raise ValueError("values_batch must be [B, n]")
    _obs.get_registry().counter(
        "repro_shard_launches_total",
        "per-rank launches of the sharded fused query").inc()
    cols = v.t().contiguous() if batched else v[:, None]
    chans = _sharded_channels(splan, cols, aggs)
    chans = tuple(c.t() if batched else c[:, 0] for c in chans)
    pack = pack_channels(aggs)
    return tuple(pack.finalize(i, chans, xp=TORCH_XP) for i in range(len(aggs)))


def query_sharded_multi(splan: ShardedDBPlan, values, aggs: Sequence[str]):
    """Fused multi-aggregate sharded query over ``values`` ``[n]``;
    returns one tensor per aggregate on every rank, bit-identical to the
    single-host ``query_dbindex_multi`` results.  Finalizers run on the
    combined channels, as the single-host executor runs them."""
    return _query(splan, values, tuple(aggs), batched=False)


def query_sharded_many(splan: ShardedDBPlan, values_batch, aggs: Sequence[str]):
    """``[B, n]`` serving traffic in the same launches: the batch rides
    K1's columns, so each pass is still one K1 launch per shard and one
    all_reduce per monoid, with a ``B``-wide payload.  Returns one
    ``[B, n]`` tensor per aggregate."""
    return _query(splan, values_batch, tuple(aggs), batched=True)


# ---------------------------------------------------------------------- #
#  Streamed update propagation: per-shard tile-group patches
# ---------------------------------------------------------------------- #
def _group_rows(sorted_seg: np.ndarray, gather_src: np.ndarray, g: int,
                ts: int, span: int):
    """Padded (seg, gather) rows of one output tile group from the full new
    arrays, or None when the group's rows no longer fit its capacity."""
    lo, hi = np.searchsorted(sorted_seg, (g * ts, (g + 1) * ts))
    if hi - lo > span:
        return None
    seg = np.full(span, -1, np.int32)
    gather = np.zeros(span, np.int32)
    seg[: hi - lo] = sorted_seg[lo:hi]
    gather[: hi - lo] = gather_src[lo:hi]
    return seg, gather


def _write_own(t: torch.Tensor, ids: np.ndarray, rows: np.ndarray, lo: int) -> None:
    """Write ``rows`` at global row ids ``ids`` into ``t``, which holds
    rows ``[lo, lo + len(t))`` (the others are another rank's), in place."""
    mine = (ids >= lo) & (ids < lo + t.shape[0])
    if mine.any():
        at = torch.from_numpy(np.asarray(ids[mine] - lo, np.int64)).to(t.device)
        t.index_copy_(0, at, upload(rows[mine], t.device, rows.dtype))


def _apply_patches(splan: ShardedDBPlan, patches, block_ids, block_sizes,
                   e1_ids, e1_rows, e2_ids, e2_rows) -> None:
    """Write one batch's patches into the host layout and, where this
    rank owns the rows, into its device shard, in place."""
    for name, pos, seg, gather in patches:
        sp, rows_cap = (splan.pass1, splan.rows1) if name == "p1" else (splan.pass2, splan.rows2)
        splan.flat[f"{name}_seg"][pos] = seg
        splan.flat[f"{name}_gather"][pos] = gather
        lo = splan.shard * rows_cap
        _write_own(sp.tiles.seg_tiles.view(-1), pos, sp.to_local(seg), lo)
        _write_own(sp.tiles.gather_padded, pos, gather, lo)
    splan.flat["block_sizes"][block_ids] = block_sizes
    _write_own(splan.block_sizes, np.asarray(block_ids), np.asarray(block_sizes, np.float32), 0)
    for key, ids, rows in (("e1", e1_ids, e1_rows), ("e2", e2_ids, e2_rows)):
        if rows is not None:
            splan.flat[key][ids] = rows
            t = getattr(splan, key)
            _write_own(t, np.asarray(ids), rows, splan.shard * t.shape[0])


def _grown_capacity(splan: ShardedDBPlan, index: DBIndex) -> int:
    """``splan``'s block capacity, grown to the next power of two past
    ``index``'s blocks when they no longer fit."""
    cap = splan.block_capacity
    if index.num_blocks > cap:
        cap = 1 << (index.num_blocks - 1).bit_length()
    return cap


def _rebuilt_plan(splan: ShardedDBPlan, index: DBIndex, stats: Dict,
                  capacity: Optional[int]) -> ShardedDBPlan:
    """A fresh layout of ``index`` on ``splan``'s mesh and headroom, the
    single-host base plan laid out on the CPU with ``block_capacity=
    capacity`` (None: sized from the index, as a reorganize sizes it)."""
    base = et.plan_from_dbindex(index, splan.tm, splan.ts, block_capacity=capacity,
                                headroom=splan.headroom, torch_device="cpu")
    return build_sharded_plan(base, splan.mesh, splan.axes, headroom=splan.headroom,
                              stats=stats, torch_device=splan.device)


def patch_sharded_plan(
    splan: ShardedDBPlan, index: DBIndex, changed_owners: np.ndarray,
    compact_garbage: float = 0.25, wire: Optional[list] = None,
) -> ShardedDBPlan:
    """Propagate one streamed batch into the plan shards.

    The wire format is *changed tile groups*: pass 1 ships only the groups
    holding appended secondary block ids, pass 2 only the groups containing
    ``changed_owners``; each patch is written into the host layout and, on
    the rank owning it, into the device shard in place (``index_copy_``;
    shapes never change in steady state).  ELL rows are row-addressed
    (block id / owner id) and patched the same way.  Falls back to a full
    rebuild when the updater rebuilt outright, capacity is exceeded, or a
    group/row no longer fits.  The patches write the live plan in place:
    a caller that must keep the old plan patches its :meth:`ShardedDBPlan.clone`.

    Delete-dominated streams accumulate *garbage blocks* (zero-link blocks
    whose member rows still occupy pass-1 tiles).  When the garbage
    fraction crosses ``compact_garbage``, pass 1 is re-packed **per shard,
    in place**: every pass-1 group whose block range holds a garbage or
    appended block is re-laid-out from the index with the garbage blocks'
    member rows dropped (groups without either are bit-identical and ship
    nothing).  Shapes never change; garbage partials become identities
    nobody gathers — a garbage block by definition has no pass-2 link.

    ``wire``, when a list, receives one serializable *replication message*
    describing exactly what this call shipped to the shards (kind
    ``"patch"``), or the full index on a rebuild (kind ``"resync"``), each
    stamped with the post-apply ``plan_crc``; a follower holding the same
    pre-patch plan replays it with :func:`apply_wire_message`.
    """
    ts = splan.ts
    stats = dict(splan.stats)
    stats["version"] = stats.get("version", 0) + 1

    def rebuild():
        stats["rebuilds"] = stats.get("rebuilds", 0) + 1
        _obs.get_registry().counter(
            "repro_plan_rebuilds_total",
            "sharded plan full rebuilds (shape-changing events)").inc()
        stats["last_patch_groups"] = -1
        stats["last_patch_per_shard"] = []  # a whole-plan upload, as a reorganize's
        stats["last_compaction"] = False
        cap = _grown_capacity(splan, index)
        out = _rebuilt_plan(splan, index, stats, cap)
        out.stats["last_patch_bytes"] = out.size_bytes()
        if wire is not None:
            wire.append(_resync_message(index, cap, out))
        return out

    if (index.stats.get("last_full_rebuild")
            or index.num_blocks > splan.block_capacity):
        return rebuild()

    owners = np.unique(np.asarray(changed_owners, np.int64))
    new_blocks = np.arange(splan.num_blocks, index.num_blocks, dtype=np.int64)
    if splan.has_ell:
        # width overflow is a rebuild-sized event — detect it before any
        # write is staged
        r1, r2 = splan.e1.shape[1], splan.e2.shape[1]
        if new_blocks.size and int(np.diff(index.block_offsets)[new_blocks].max()) > r1:
            return rebuild()
        if owners.size and int(np.diff(index.link_owner_offsets)[owners].max()) > r2:
            return rebuild()
    member_block = np.asarray(index.member_block_ids, np.int64)
    link_owner = np.asarray(index.link_owner_ids, np.int64)

    # per-shard pass-1 garbage compaction: only groups whose block range
    # holds fresh garbage (rows still laid out) or an appended block
    # differ from the layout; ``p1_compacted_ids`` records whose rows are
    # already gone, so later batches neither re-ship nor resurrect them
    linked = index.linked_blocks_mask()
    garbage = np.flatnonzero(~linked[: index.num_blocks]).astype(np.int64)
    already = np.asarray(stats.get("p1_compacted_ids", []), np.int64)
    fresh_garbage = np.setdiff1d(garbage, already)
    over = (index.num_blocks > 0
            and index.garbage_block_fraction(linked) >= compact_garbage)
    compacting = over and fresh_garbage.size > 0
    filter_garbage = compacting or already.size > 0
    if filter_garbage:
        keep = linked[member_block]
        p1_seg_src = member_block[keep]
        p1_gather_src = index.block_members[keep]
    else:
        p1_seg_src, p1_gather_src = member_block, index.block_members
    dirty = (np.concatenate([fresh_garbage, new_blocks]) if compacting
             else new_blocks)
    p1_groups = np.unique(dirty // ts)
    if filter_garbage and p1_groups.size:
        shipped = garbage[np.isin(garbage // ts, p1_groups)]
        stats["p1_compacted_ids"] = np.union1d(already, shipped).tolist()
    if compacting:
        stats["p1_compactions"] = stats.get("p1_compactions", 0) + 1
    stats["last_compaction"] = bool(compacting)

    per_shard = np.zeros(splan.ndev, np.int64)
    patches: List[Tuple] = []  # (pass_name, flat positions, seg, gather)
    groups_patched = 0
    for pass_id, groups, seg_src, gather_src in (
        (1, p1_groups, p1_seg_src, p1_gather_src),
        (2, np.unique(owners // ts), link_owner, index.link_block),
    ):
        if groups.size == 0:
            continue
        tiles = splan.group_tiles1 if pass_id == 1 else splan.group_tiles2
        shard_of = splan.group_shard1 if pass_id == 1 else splan.group_shard2
        offset = splan.group_off1 if pass_id == 1 else splan.group_off2
        rows_cap = splan.rows1 if pass_id == 1 else splan.rows2
        pos_chunks, seg_chunks, gather_chunks = [], [], []
        for g in groups:
            span = int(tiles[g]) * splan.tm
            rows = _group_rows(seg_src, gather_src, int(g), ts, span)
            if rows is None:  # group outgrew its tile capacity
                return rebuild()
            lo = int(shard_of[g]) * rows_cap + int(offset[g])
            pos_chunks.append(np.arange(lo, lo + span, dtype=np.int64))
            seg_chunks.append(rows[0])
            gather_chunks.append(rows[1])
            per_shard[int(shard_of[g])] += span * 8  # seg + gather, i32 each
            groups_patched += 1
        patches.append((f"p{pass_id}", np.concatenate(pos_chunks),
                        np.concatenate(seg_chunks), np.concatenate(gather_chunks)))

    sizes = np.empty(0, np.float32)
    if new_blocks.size:
        sizes = np.diff(index.block_offsets)[new_blocks].astype(np.float32)
        per_shard += (new_blocks.size * 4) // splan.ndev  # replicated bcast
    e1_rows = e2_rows = None
    if splan.has_ell:  # widths already validated before any write
        if new_blocks.size:
            e1_rows = et._ell_rows_for_new_blocks(index, splan.num_blocks, r1)
            np.add.at(per_shard, (new_blocks // splan.e1.shape[0]).astype(np.int64), r1 * 4)
        if owners.size:
            e2_rows = et._ell_rows_for_owners(index, owners, r2)
            np.add.at(per_shard, (owners // splan.e2.shape[0]).astype(np.int64), r2 * 4)
    e1_ids = new_blocks if e1_rows is not None else np.empty(0, np.int64)
    e2_ids = owners if e2_rows is not None else np.empty(0, np.int64)
    _apply_patches(splan, patches, new_blocks, sizes, e1_ids, e1_rows, e2_ids, e2_rows)

    patch_bytes = int(per_shard.sum())
    _obs.get_registry().counter(
        "repro_patch_bytes_total",
        "bytes of tile-group patches shipped to plan shards").inc(patch_bytes)
    stats.update(
        last_patch_bytes=patch_bytes,
        last_patch_groups=groups_patched,
        last_patch_per_shard=per_shard.tolist(),
        patched_bytes_total=stats.get("patched_bytes_total", 0) + patch_bytes,
    )
    out = dataclasses.replace(splan, num_blocks=index.num_blocks, stats=stats)
    if wire is not None:
        from repro_torch.obs.audit import plan_crc

        wire.append({
            "kind": "patch",
            "num_blocks": int(index.num_blocks),
            "patches": patches,
            "block_ids": new_blocks,
            "block_sizes": sizes,
            "e1_ids": e1_ids,
            "e1_rows": e1_rows,
            "e2_ids": e2_ids,
            "e2_rows": e2_rows,
            # post-apply content digest of the plan this message produces
            "plan_crc": plan_crc(out),
        })
    return out


# ---------------------------------------------------------------------- #
#  Replication messages (the patch stream on the wire)
# ---------------------------------------------------------------------- #
def _resync_message(index: DBIndex, capacity: Optional[int], out: ShardedDBPlan) -> Dict:
    """The ``"resync"`` message of a rebuild into ``out``: the index, the
    block capacity the rebuild asked for (None: a reorganize's, sized from
    the index) and the post-apply content digest, so a follower rebuilds
    the same plan and checks it (:func:`apply_wire_message`)."""
    from repro_torch.obs.audit import plan_crc

    return {"kind": "resync", "index": index, "capacity": capacity,
            "plan_crc": plan_crc(out)}


class WireDivergenceError(RuntimeError):
    """A replayed wire message produced a plan whose content digest does
    not match the leader's ``plan_crc`` stamp (the follower held different
    pre-patch state, or the message was corrupted in transit)."""


def apply_wire_message(splan: ShardedDBPlan, msg: Dict,
                       verify: bool = True) -> ShardedDBPlan:
    """Replay one :func:`patch_sharded_plan` wire message on a follower's
    plan (in place, as the leader patched).  The follower must hold the
    same plan state the leader held before the message was produced (apply
    the stream in order, no gaps); positions and row ids in a ``"patch"``
    message are absolute, so the replay is exactly the leader's writes.  A
    ``"resync"`` message (leader rebuilt) carries the full index and the
    capacity the leader's rebuild asked for, and rebuilds the follower the
    same deterministic way (a message without a capacity, as the
    reference's codec writes it, takes the follower's own, grown to fit).

    When the message carries the leader's post-apply ``plan_crc`` stamp
    and ``verify`` is on, the follower recomputes its own plan digest and
    raises :class:`WireDivergenceError` on mismatch."""
    stats = dict(splan.stats)
    stats["version"] = stats.get("version", 0) + 1
    if msg["kind"] == "resync":
        stats["rebuilds"] = stats.get("rebuilds", 0) + 1
        index = msg["index"]
        cap = msg["capacity"] if "capacity" in msg else _grown_capacity(splan, index)
        return _verify_wire_crc(_rebuilt_plan(splan, index, stats, cap), msg, verify)
    if msg["kind"] != "patch":
        raise ValueError(f"unknown wire message kind {msg['kind']!r}")
    _apply_patches(splan, msg["patches"], msg["block_ids"], msg["block_sizes"],
                   msg["e1_ids"], msg["e1_rows"], msg["e2_ids"], msg["e2_rows"])
    out = dataclasses.replace(splan, num_blocks=int(msg["num_blocks"]), stats=stats)
    return _verify_wire_crc(out, msg, verify)


def _verify_wire_crc(out: ShardedDBPlan, msg: Dict,
                     verify: bool) -> ShardedDBPlan:
    expect = msg.get("plan_crc")
    if verify and expect is not None:
        from repro_torch.obs.audit import plan_crc

        got = plan_crc(out)
        if got != int(expect):
            _obs.get_registry().counter(
                "repro_wire_divergence_total",
                "wire-replayed plans failing the leader's plan_crc").inc()
            raise WireDivergenceError(
                f"{msg['kind']} replay digest mismatch: "
                f"leader={int(expect):#010x} follower={got:#010x}")
    return out


def encode_wire_message(msg: Dict) -> bytes:
    """Serialize one replication message to bytes (``np.savez``-framed;
    no pickling — index stats ride as JSON)."""
    import io
    import json

    arrays: Dict[str, np.ndarray] = {}
    meta: Dict = {"kind": msg["kind"]}
    if msg.get("plan_crc") is not None:
        meta["plan_crc"] = int(msg["plan_crc"])
    if msg["kind"] == "resync":
        idx = msg["index"]
        meta["n"] = int(idx.n)
        meta["num_blocks"] = int(idx.num_blocks)
        meta["stats"] = {k: v for k, v in idx.stats.items()
                         if isinstance(v, (int, float, bool, str))}
        if "capacity" in msg:
            meta["capacity"] = None if msg["capacity"] is None else int(msg["capacity"])
        arrays["block_members"] = np.asarray(idx.block_members)
        arrays["block_offsets"] = np.asarray(idx.block_offsets)
        arrays["link_block"] = np.asarray(idx.link_block)
        arrays["link_owner_offsets"] = np.asarray(idx.link_owner_offsets)
    else:
        meta["num_blocks"] = int(msg["num_blocks"])
        meta["patch_names"] = [name for name, *_ in msg["patches"]]
        for i, (name, pos, seg, gather) in enumerate(msg["patches"]):
            arrays[f"patch{i}_pos"] = pos
            arrays[f"patch{i}_seg"] = seg
            arrays[f"patch{i}_gather"] = gather
        arrays["block_ids"] = msg["block_ids"]
        arrays["block_sizes"] = msg["block_sizes"]
        for key in ("e1", "e2"):
            rows = msg[f"{key}_rows"]
            meta[f"has_{key}"] = rows is not None
            arrays[f"{key}_ids"] = np.asarray(msg[f"{key}_ids"])
            if rows is not None:
                arrays[f"{key}_rows"] = rows
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    header = json.dumps(meta).encode()
    return len(header).to_bytes(4, "little") + header + buf.getvalue()


def decode_wire_message(data: bytes) -> Dict:
    """Inverse of :func:`encode_wire_message`."""
    import io
    import json

    hlen = int.from_bytes(data[:4], "little")
    meta = json.loads(data[4: 4 + hlen].decode())
    arrays = dict(np.load(io.BytesIO(data[4 + hlen:]), allow_pickle=False))
    if meta["kind"] == "resync":
        index = DBIndex(
            n=int(meta["n"]),
            num_blocks=int(meta["num_blocks"]),
            block_members=arrays["block_members"],
            block_offsets=arrays["block_offsets"],
            link_block=arrays["link_block"],
            link_owner_offsets=arrays["link_owner_offsets"],
            stats=dict(meta["stats"]),
        )
        out = {"kind": "resync", "index": index}
        if "capacity" in meta:
            out["capacity"] = meta["capacity"]
        if "plan_crc" in meta:
            out["plan_crc"] = int(meta["plan_crc"])
        return out
    msg: Dict = {
        "kind": "patch",
        "num_blocks": int(meta["num_blocks"]),
        "patches": [
            (name, arrays[f"patch{i}_pos"], arrays[f"patch{i}_seg"],
             arrays[f"patch{i}_gather"])
            for i, name in enumerate(meta["patch_names"])
        ],
        "block_ids": arrays["block_ids"],
        "block_sizes": arrays["block_sizes"],
    }
    for key in ("e1", "e2"):
        msg[f"{key}_ids"] = arrays[f"{key}_ids"]
        msg[f"{key}_rows"] = arrays[f"{key}_rows"] if meta[f"has_{key}"] else None
    if "plan_crc" in meta:
        msg["plan_crc"] = int(meta["plan_crc"])
    return msg


# ---------------------------------------------------------------------- #
#  Sharded streaming state (graph + index + plan shards under updates)
# ---------------------------------------------------------------------- #
class ShardedStreamState(StreamingEngine):
    """Per-window streaming state with plan shards on each rank's device.

    A :class:`repro_torch.core.streaming.StreamingEngine` (the same
    maintenance policy, metrics and reports) whose plan is a
    :class:`ShardedDBPlan` and whose update propagation is distributed:
    each rank runs the affected-owner BFS of its own seed slice, one
    ``all_reduce`` unions them, and only the dirty tile groups are
    written, each into the shard owning it.  Its reports add the per-shard
    owner counts and the patch bytes shipped.
    """

    _span_tags = {"sharded": True}

    def __init__(
        self,
        g: Graph,
        window,
        mesh,
        axis="data",
        *,
        method: str = "emc",
        policy: Optional[StalenessPolicy] = None,
        tm: int = 512,
        ts: int = 512,
        plan_headroom: float = 0.5,
        # below StalenessPolicy.max_garbage_ratio (0.5) on purpose: the
        # in-place sharded compaction is shape-stable, so it should fire
        # well before a policy rebuild is due
        compact_garbage: float = 0.25,
        use_device_bfs: Optional[bool] = None,
        capture_wire: bool = False,
        obs=None,
        tracer=None,
        torch_device="cuda",
    ):
        #: replication stream: one message per applied batch when enabled
        #: (``patch_sharded_plan``'s wire format — see ``apply_wire_message``)
        self.wire_log: Optional[list] = [] if capture_wire else None
        self.mesh, self.axes = mesh, _axes_tuple(axis)
        super().__init__(
            g, window, index_kind="dbindex", method=method, policy=policy,
            tm=tm, ts=ts, plan_headroom=plan_headroom,
            compact_garbage=compact_garbage, use_device_bfs=use_device_bfs,
            obs=obs, tracer=tracer, torch_device=torch_device)

    def _build(self, initial: bool = False) -> None:
        prev = getattr(self, "plan", None)
        super()._build(initial)
        if prev is not None:
            # a reorganize re-uploads the whole plan: the patch telemetry
            # must say so, not echo the previous batch's few-KB patch
            self.plan.stats.update(
                last_patch_bytes=self.plan.size_bytes(),
                last_patch_groups=-1,
                last_patch_per_shard=[],
                rebuilds=self.plan.stats.get("rebuilds", 0) + 1,
                version=self.plan.stats.get("version", 0) + 1,
            )
        if not initial and self.wire_log is not None:
            self.wire_log.append(_resync_message(self.index, None, self.plan))

    def _new_plan(self) -> ShardedDBPlan:
        base = et.plan_from_dbindex(self.index, self.tm, self.ts,
                                    headroom=self.plan_headroom, torch_device="cpu")
        prev = getattr(self, "plan", None)
        return build_sharded_plan(
            base, self.mesh, self.axes, headroom=self.plan_headroom,
            stats=prev.stats if prev is not None else None,
            torch_device=self.torch_device)

    def _patch_plan(self, index, owners: np.ndarray) -> ShardedDBPlan:
        return patch_sharded_plan(self.plan, index, owners,
                                  compact_garbage=self.compact_garbage,
                                  wire=self.wire_log)

    def _update_index(self, g2: Graph, batch: UpdateBatch):
        owners, per_shard = spmd_affected_owners(
            g2, self.window, batch, self.plan.ndev, self.plan.shard,
            group=self.plan.group, use_device=self.use_device_bfs,
            torch_device=self.torch_device)
        idx2, changed = update_dbindex_batch(self.index, g2, self.window,
                                             batch, owners=owners)
        return idx2, changed, {"affected_per_shard": per_shard}

    def _finish_report(self, rep: Dict, extra: Optional[Dict]) -> Dict:
        st = self.plan.stats
        if extra is None:  # attribute-only: shipped only when it re-filtered
            shipped = rep.get("refiltered", False)
            rebuilt = rep["reorganized"]
            extra = {"affected_per_shard": []}
        else:
            # the patcher itself may have rebuilt (updater full rebuild,
            # capacity or ELL-width overflow): a full-plan re-upload
            shipped = True
            rebuilt = st.get("last_patch_groups") == -1
        rep.update(
            extra,
            compacted=bool(st.get("last_compaction", False)) if shipped else False,
            patch_bytes=int(st.get("last_patch_bytes", 0)) if shipped else 0,
            patch_bytes_per_shard=st.get("last_patch_per_shard", []) if shipped else [],
            full_plan_bytes=int(st.get("full_bytes", 0)),
            reorganized=rep["reorganized"] or rebuilt,
            plan_rebuilt=rebuilt,
        )
        return rep

    # ------------------------------------------------------------------ #
    def query_multi(self, aggs: Sequence[str], values=None) -> list:
        if values is None:
            values = self.graph.attrs["val"]
        outs = query_sharded_multi(self.plan, values, tuple(aggs))
        return [o.cpu().numpy() for o in outs]

    def query(self, agg: str = "sum", values=None) -> np.ndarray:
        return self.query_multi((agg,), values)[0]


# ---------------------------------------------------------------------- #
#  ShardedSession — Session(mesh=...) across the mesh
# ---------------------------------------------------------------------- #
from repro_torch.core.api import Session, SessionView  # noqa: E402  (api imports us lazily)


class ShardedSession(Session):
    """A :class:`~repro_torch.core.api.Session` whose device groups run
    across a mesh, SPMD: every rank constructs it with the same arguments
    and calls it in the same order.  Query planning selects sharded
    capabilities (``torch-sharded``), every distinct window gets a plan
    shard on each rank's device, and streamed ``UpdateBatch``es propagate
    as per-shard tile-group patches.  Construct directly or via
    ``Session(g, specs, mesh=mesh)`` — every Session kwarg (policy,
    headroom, method, pins, ``compact_garbage``, ``torch_device``, ...)
    keeps its meaning; ``compact_garbage=None`` means 0.25 here (the
    in-place compaction is shape-stable, so it fires before a rebuild).

    One caller over every rank (a :class:`~repro_torch.serve.WindowService`,
    an ``AsyncWindowService`` with its flusher thread): the group's lowest
    rank calls :meth:`lead`, every other rank :meth:`follow`.  The leader's
    session then sends each call that reaches a collective (a sharded
    group's query at a view's version, ``update``, ``analyze``) as a small
    op record over a gloo side group, under the session's lock, before it
    runs it; a follower replays every record on its own session, in the
    leader's order, until :meth:`stop_followers`.  The service stays
    unaware of the mesh.
    """

    _sharded = True

    def __init__(self, g: Graph, specs, *, mesh, axis="data", **kw):
        if mesh is None:
            raise ValueError("ShardedSession needs a mesh")
        self.axes = _axes_tuple(axis)
        #: the op channel while this rank leads (see :meth:`lead`)
        self._ops: Optional[_OpChannel] = None
        super().__init__(g, specs, mesh=mesh, axis=axis, **kw)

    # ------------------------------------------------------------------ #
    def _make_state(self, window, kind: str, device: bool, sharded: bool = False):
        if not sharded:  # e.g. explicitly pinned host / iindex groups
            return super()._make_state(window, kind, device, sharded)
        cfg = self._state_cfg
        cg = cfg["compact_garbage"]
        return ShardedStreamState(
            self.graph, window, self.mesh, cfg["axis"],
            method=cfg["method"], policy=cfg["policy"],
            tm=cfg["tm"], ts=cfg["ts"],
            plan_headroom=cfg["plan_headroom"],
            compact_garbage=0.25 if cg is None else cg,
            use_device_bfs=cfg["use_device_bfs"],
            obs=self.obs, tracer=self.tracer, torch_device=self.torch_device,
        )

    def _group_artifacts(self, gi):
        """A (window, kind) state shared between a sharded group and a
        pinned non-sharded device group holds a :class:`ShardedDBPlan`,
        which single-host executors cannot consume — hand those groups the
        index only (their runner builds a host plan per call)."""
        arts = super()._group_artifacts(gi)
        cap = self.registry.capability(self.compiled.groups[gi].engine)
        if not cap.sharded:
            arts = tuple(
                (index, None if isinstance(plan, ShardedDBPlan) else plan)
                for index, plan in arts
            )
        return arts

    # ------------------------------------------------------------------ #
    def _exec_term_many(self, grp, window, index, plan, vb, g, aggs):
        """Serving traffic across the mesh: a sharded plan takes the whole
        [B, n] bucket in one fused query (K1's batch columns)."""
        if isinstance(plan, ShardedDBPlan):
            with self.tracer.span("query.term", cat="query", engine=grp.engine,
                                  window=window.name(), rows=len(vb)):
                outs = query_sharded_many(plan, vb, tuple(aggs))
                return {a: o.cpu().numpy() for a, o in zip(aggs, outs)}
        return super()._exec_term_many(grp, window, index, plan, vb, g, aggs)

    # ------------------------------------------------------------------ #
    #  One caller over every rank: the leader replicates, followers replay
    # ------------------------------------------------------------------ #
    def _combine_group(self):
        return _mesh_shard(self.mesh, self.axes)[2]

    def lead(self) -> "ShardedSession":
        """Make this rank, the lowest of the combine group, the one caller
        of the session: from now on every call of it that reaches a
        collective is first sent to the followers (:meth:`follow`, called
        by every other rank of the group; both sides create the gloo side
        group together).  Returns the session."""
        self._ops = _OpChannel(self._combine_group(), lead=True)
        return self

    def stop_followers(self) -> None:
        """End every follower's :meth:`follow` loop; this rank leads no
        more."""
        ch, self._ops = self._ops, None
        if ch is not None:
            with self._lock:
                ch.send(("stop",))

    def follow(self) -> int:
        """Replay the leader's op records on this rank's session until the
        leader stops; returns the records replayed.  A record whose replay
        raises ends the loop with that error: this rank has left the
        leader's order, and the leader's next collective cannot complete, so
        the caller must fail (end the process) rather than go on."""
        ch = _OpChannel(self._combine_group(), lead=False)
        views: Dict[int, SessionView] = {}
        replayed = 0
        while True:
            rec = ch.receive()
            if rec[0] == "stop":
                return replayed
            replayed += 1
            self._replay(rec, views)

    def _replay(self, rec, views: Dict[int, SessionView]) -> None:
        op = rec[0]
        if op == "update":
            _, batch, live = rec
            # hold the versions the leader's live views hold, so this rank
            # clones (copy-on-write) where the leader did
            keep = {v: views[v] for v in live if v in views}
            if self.version in live and self.version not in keep:
                keep[self.version] = self.snapshot()
            views.clear()
            views.update(keep)
            self.update(batch)
        elif op == "analyze":
            self.analyze(rec[1], values=rec[2])
        else:
            _, gi, version, values = rec
            view = views.get(version)
            if view is None and version == self.version:
                view = self.snapshot()
            if view is None:
                raise RuntimeError(f"no view at version {version} "
                                   f"(head {self.version}): diverged from the leader")
            if op == "group":
                self._run_view_group(view, gi, values)
            else:
                self._run_view_group_many(view, gi, values)

    def _leading(self, gi: Optional[int] = None) -> bool:
        if self._ops is None or not self._ops.followers:
            return False
        return gi is None or self.registry.capability(
            self.compiled.groups[gi].engine).sharded

    def _run_view_group(self, view, gi: int, values):
        if not self._leading(gi):
            return super()._run_view_group(view, gi, values)
        with self._lock:
            self._ops.send(("group", gi, view.version, _portable(values)))
            return super()._run_view_group(view, gi, values)

    def _run_view_group_many(self, view, gi: int, vb):
        if not self._leading(gi):
            return super()._run_view_group_many(view, gi, vb)
        with self._lock:
            self._ops.send(("group_many", gi, view.version, _portable(vb)))
            return super()._run_view_group_many(view, gi, vb)

    def _update_inner(self, batch) -> Dict:
        if self._leading():  # Session.update holds the lock
            live = sorted({v.version for v in list(self._views)})
            self._ops.send(("update", batch, live))
        return super()._update_inner(batch)

    def analyze(self, spec=None, values=None):
        if not self._leading():
            return super().analyze(spec, values=values)
        with self._lock:
            self._ops.send(("analyze", spec, _portable(values)))
            return super().analyze(spec, values=values)


def _portable(values):
    """Op-record values as host arrays (a CUDA tensor would unpickle onto
    the leader's card)."""
    if isinstance(values, torch.Tensor):
        return values.cpu().numpy()
    if isinstance(values, dict):
        return {k: _portable(v) for k, v in values.items()}
    return values


class _OpChannel:
    """A gloo side group over the combine group's ranks, the lowest
    leading: :meth:`send` broadcasts one picklable record from the leader,
    :meth:`receive` takes it on a follower.  Records are few and small (an
    op, a group, a version, the values or the ``UpdateBatch``), so they
    travel as pickled objects on the host whatever backend the mesh uses."""

    def __init__(self, group, lead: bool):
        ranks = dist.get_process_group_ranks(group)
        self.leader = min(ranks)
        me = dist.get_rank()
        if lead != (me == self.leader):
            raise ValueError(f"rank {me}: the group's lowest rank {self.leader} "
                             "leads and every other rank follows")
        self.followers = len(ranks) - 1
        self.group = (dist.new_group(ranks, backend="gloo",
                                     use_local_synchronization=True)
                      if self.followers else None)

    def send(self, rec) -> None:
        if self.followers:
            dist.broadcast_object_list([rec], src=self.leader, group=self.group)

    def receive(self):
        box = [None]
        dist.broadcast_object_list(box, src=self.leader, group=self.group)
        return box[0]

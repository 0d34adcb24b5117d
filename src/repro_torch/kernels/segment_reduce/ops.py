"""Host tile-plan builder + wrappers for the segment-sum kernel (K1).

``build_tile_plan`` runs once at *index build time* (host, NumPy): it
renumbers nothing (ids are already dense) but groups rows by output tile and
pads so the kernel sees a tile-aligned layout.  The returned plan holds
int32 tensors on an explicit device.

``segment_sum(plan, values)`` = fused gather + tiled segment sum, and
``segment_reduce_multi(plan, values, monoids)`` the same with a sum, min or
max per column: one K1 launch on a CUDA tensor either way.
``segment_reduce(...)`` is the general entry point by op name.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device, upload
from repro_torch.kernels.segment_reduce.segment_reduce import (
    DEFAULT_TM,
    DEFAULT_TS,
    segment_reduce_tiled,
)

#: the K1 monoid split (n_sum, n_min, n_max) of ``c`` columns all of ``op``
_ALL_OF = {"add": lambda c: (c, 0, 0), "min": lambda c: (0, c, 0),
           "max": lambda c: (0, 0, c)}


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """Static-shape device plan for one sorted segment reduction."""

    gather_padded: torch.Tensor  # int32 [Mpad] index into values rows (0 on pad)
    seg_tiles: torch.Tensor  # int32 [nm, TM]; -1 on padding rows
    m2out: torch.Tensor  # int32 [nm]
    first_visit: torch.Tensor  # int32 [nm]
    num_segments: int
    num_out_tiles: int
    tm: int
    ts: int
    device: torch.device

    def named_arrays(self) -> "dict":
        """The plan's tensors by name: what :meth:`array_nbytes` counts and
        the audit digest folds."""
        return {"gather_padded": self.gather_padded, "seg_tiles": self.seg_tiles,
                "m2out": self.m2out, "first_visit": self.first_visit}

    def array_nbytes(self) -> "dict":
        """Per-array device bytes held by this plan (exact)."""
        return {k: _nbytes(t) for k, t in self.named_arrays().items()}

    def clone(self) -> "TilePlan":
        """The same plan in fresh storage (device-to-device copies on the
        current stream): a patch of the clone leaves this plan as it is."""
        return dataclasses.replace(
            self, **{k: t.clone() for k, t in self.named_arrays().items()})

    def plan_nbytes(self) -> int:
        return sum(self.array_nbytes().values())


def _nbytes(t: torch.Tensor) -> int:
    return int(t.numel() * t.element_size())


def build_tile_plan(
    gather_idx: np.ndarray,
    segment_ids: np.ndarray,
    num_segments: int,
    tm: int = DEFAULT_TM,
    ts: int = DEFAULT_TS,
    headroom: float = 0.0,
    group_min_tiles: "Optional[np.ndarray]" = None,
    torch_device="cuda",
) -> TilePlan:
    """Host-side plan: rows (sorted by segment id) -> tile-aligned layout.

    ``headroom`` > 0 over-allocates every tile group by an even share of
    ``total_rows * headroom`` extra row capacity.  Streamed updates append
    rows into a few hot groups (e.g. secondary blocks land in the capacity
    tail); the spread keeps :func:`patch_tile_plan` shape-stable until the
    cumulative growth exceeds the slack.  ``group_min_tiles`` optionally
    floors individual groups' tile counts — the caller's way to concentrate
    slack where appends will land.
    """
    dev = resolve_device(torch_device)
    gather_idx = np.asarray(gather_idx, np.int32)
    segment_ids = np.asarray(segment_ids, np.int64)
    assert gather_idx.shape == segment_ids.shape
    if segment_ids.size:
        assert (np.diff(segment_ids) >= 0).all(), "segment_ids must be sorted"
    sizes = np.bincount(segment_ids, minlength=num_segments).astype(np.int64)
    n_out_tiles = max(1, -(-num_segments // ts))
    group_rows = np.add.reduceat(sizes, np.arange(0, num_segments, ts)) if num_segments else np.zeros(1, np.int64)
    if group_rows.size < n_out_tiles:
        group_rows = np.pad(group_rows, (0, n_out_tiles - group_rows.size))
    # >=1 input tile per output tile so every output block gets initialized
    tiles_per_group = np.maximum(1, -(-group_rows // tm))
    if headroom > 0:
        extra = max(1, -(-int(group_rows.sum() * headroom) // (n_out_tiles * tm)))
        tiles_per_group = tiles_per_group + extra
    if group_min_tiles is not None:
        tiles_per_group = np.maximum(
            tiles_per_group, group_min_tiles[:n_out_tiles].astype(np.int64)
        )
    padded_rows = tiles_per_group * tm
    total_pad = int(padded_rows.sum())
    nm = int(tiles_per_group.sum())
    # scatter original rows into the padded layout
    src_group_start = np.zeros(n_out_tiles + 1, np.int64)
    np.cumsum(group_rows, out=src_group_start[1:])
    dst_group_start = np.zeros(n_out_tiles + 1, np.int64)
    np.cumsum(padded_rows, out=dst_group_start[1:])
    row_map = np.full(total_pad, -1, dtype=np.int64)
    if segment_ids.size:
        within = np.arange(segment_ids.size) - np.repeat(
            src_group_start[:-1], group_rows
        )
        dst = np.repeat(dst_group_start[:-1], group_rows) + within
        row_map[dst] = np.arange(segment_ids.size)
    seg_padded = np.full(total_pad, -1, dtype=np.int32)
    valid = row_map >= 0
    seg_padded[valid] = segment_ids[row_map[valid]]
    gather_padded = np.zeros(total_pad, dtype=np.int32)
    gather_padded[valid] = gather_idx[row_map[valid]]
    m2out = np.repeat(np.arange(n_out_tiles, dtype=np.int32), tiles_per_group)
    return _plan(gather_padded, seg_padded.reshape(nm, tm), m2out,
                 num_segments, n_out_tiles, tm, ts, dev)


def _plan(gather_padded, seg_tiles, m2out, num_segments, n_out_tiles, tm, ts,
          dev) -> TilePlan:
    first_visit = np.empty(m2out.size, dtype=np.int32)
    first_visit[0] = 1
    first_visit[1:] = (np.diff(m2out) != 0).astype(np.int32)
    return TilePlan(
        gather_padded=upload(gather_padded, dev),
        seg_tiles=upload(seg_tiles, dev),
        m2out=upload(m2out, dev),
        first_visit=upload(first_visit, dev),
        num_segments=int(num_segments),
        num_out_tiles=n_out_tiles,
        tm=tm,
        ts=ts,
        device=dev,
    )


def patch_tile_plan(
    plan: TilePlan,
    gather_idx: np.ndarray,
    segment_ids: np.ndarray,
    num_segments: int,
    changed_segments: np.ndarray,
) -> TilePlan:
    """Incrementally rebuild a tile plan after a sparse segment change.

    ``gather_idx``/``segment_ids`` are the FULL new row arrays (sorted by
    segment id, same contract as :func:`build_tile_plan`); the caller
    guarantees that every segment whose row set changed is listed in
    ``changed_segments``.  Only output-tile groups containing a changed
    segment are re-laid-out; untouched groups reuse their existing padded
    rows verbatim.  A changed group keeps its old tile capacity when the
    new rows still fit (extra tiles are all-padding rows the kernel skips),
    so steady-state streams produce plans with *identical shapes*.
    ``num_segments`` may grow (e.g. appended secondary blocks); new groups
    are appended at the end.

    The shape-stable path writes the changed groups **in place** into the
    live ``gather_padded`` / ``seg_tiles`` tensors (``index_copy_``), so the
    returned plan shares them with ``plan``: a holder of the old plan sees
    the patched rows (:meth:`repro_torch.core.api.Session.update` patches a
    :meth:`TilePlan.clone` instead while a live view holds the plan).
    """
    gather_idx = np.asarray(gather_idx, np.int32)
    segment_ids = np.asarray(segment_ids, np.int64)
    assert gather_idx.shape == segment_ids.shape
    if segment_ids.size:
        assert (np.diff(segment_ids) >= 0).all(), "segment_ids must be sorted"
    tm, ts, dev = plan.tm, plan.ts, plan.device
    n_out_old = plan.num_out_tiles
    n_out_new = max(1, -(-num_segments // ts))
    if n_out_new < n_out_old:  # shrinking segment space: no reuse story
        return build_tile_plan(gather_idx, segment_ids, num_segments, tm, ts,
                               torch_device=dev)

    old_m2out = plan.m2out.cpu().numpy()
    old_tiles = np.bincount(old_m2out, minlength=n_out_old).astype(np.int64)
    old_starts = np.zeros(n_out_old + 1, np.int64)
    np.cumsum(old_tiles * tm, out=old_starts[1:])

    changed_mask = np.zeros(n_out_new, dtype=bool)
    cs = np.asarray(changed_segments, np.int64)
    changed_mask[np.unique(cs[cs < num_segments]) // ts] = True
    changed_mask[n_out_old:] = True  # appended groups are always new

    # per-group row ranges in the new arrays
    bounds = np.searchsorted(
        segment_ids, np.arange(n_out_new + 1, dtype=np.int64) * ts
    )
    rows_per_group = np.diff(bounds)
    tiles_needed = np.maximum(1, -(-rows_per_group // tm))
    old_tiles_ext = np.zeros(n_out_new, np.int64)
    old_tiles_ext[:n_out_old] = old_tiles
    tiles_new = np.where(
        changed_mask, np.maximum(tiles_needed, old_tiles_ext), old_tiles_ext
    )
    new_starts = np.zeros(n_out_new + 1, np.int64)
    np.cumsum(tiles_new * tm, out=new_starts[1:])
    total_pad = int(new_starts[-1])
    nm = int(tiles_new.sum())

    if n_out_new == n_out_old and np.array_equal(tiles_new, old_tiles):
        # Shape-stable steady state: write only the changed tile groups into
        # the live device tensors, in place, instead of round-tripping the
        # whole plan through host memory and re-uploading it.  m2out,
        # first_visit and every shape are reused.
        pos_chunks, seg_chunks, gather_chunks = [], [], []
        for g in np.flatnonzero(changed_mask):
            lo, span = int(new_starts[g]), int(tiles_new[g]) * tm
            r0, r1 = int(bounds[g]), int(bounds[g + 1])
            seg_rows = np.full(span, -1, dtype=np.int32)
            gather_rows = np.zeros(span, dtype=np.int32)
            seg_rows[: r1 - r0] = segment_ids[r0:r1]
            gather_rows[: r1 - r0] = gather_idx[r0:r1]
            pos_chunks.append(np.arange(lo, lo + span, dtype=np.int64))
            seg_chunks.append(seg_rows)
            gather_chunks.append(gather_rows)
        if pos_chunks:
            pos = torch.from_numpy(np.concatenate(pos_chunks)).to(dev)
            plan.seg_tiles.view(-1).index_copy_(
                0, pos, upload(np.concatenate(seg_chunks), dev))
            plan.gather_padded.index_copy_(
                0, pos, upload(np.concatenate(gather_chunks), dev))
        return dataclasses.replace(plan, num_segments=int(num_segments),
                                   num_out_tiles=n_out_new)

    old_seg = plan.seg_tiles.cpu().numpy().reshape(-1)
    old_gather = plan.gather_padded.cpu().numpy()
    seg_padded = np.full(total_pad, -1, dtype=np.int32)
    gather_padded = np.zeros(total_pad, dtype=np.int32)
    for g in range(n_out_new):
        lo = int(new_starts[g])
        if changed_mask[g]:
            r0, r1 = int(bounds[g]), int(bounds[g + 1])
            seg_padded[lo : lo + (r1 - r0)] = segment_ids[r0:r1]
            gather_padded[lo : lo + (r1 - r0)] = gather_idx[r0:r1]
        else:
            o0 = int(old_starts[g])
            span = int(old_tiles[g]) * tm
            seg_padded[lo : lo + span] = old_seg[o0 : o0 + span]
            gather_padded[lo : lo + span] = old_gather[o0 : o0 + span]
    m2out = np.repeat(np.arange(n_out_new, dtype=np.int32), tiles_new)
    return _plan(gather_padded, seg_padded.reshape(nm, tm), m2out,
                 num_segments, n_out_new, tm, ts, dev)


def _segment_reduce(plan: TilePlan, values: torch.Tensor, gather,
                    monoids=None) -> torch.Tensor:
    squeeze = values.dim() == 1
    v = values[:, None] if squeeze else values
    out = segment_reduce_tiled(
        v.to(torch.float32).contiguous(), gather, plan.seg_tiles, plan.m2out,
        monoids=monoids or (v.shape[1], 0, 0),
        num_out_tiles=plan.num_out_tiles, tm=plan.tm, ts=plan.ts,
    )[: plan.num_segments]
    return out[:, 0] if squeeze else out


def segment_sum_gathered(plan: TilePlan, gathered: torch.Tensor) -> torch.Tensor:
    """Tiled segment sum over pre-gathered rows ([Mpad] or [Mpad, D]) ->
    [S(, D)] float32."""
    return _segment_reduce(plan, gathered, None)


def segment_sum(plan: TilePlan, values: torch.Tensor) -> torch.Tensor:
    """Fused gather + tiled segment sum (one kernel launch on the card).
    values: [N] or [N, D] -> [S(, D)] float32."""
    return _segment_reduce(plan, values, plan.gather_padded)


def segment_reduce_multi(plan: TilePlan, values: torch.Tensor,
                         monoids) -> torch.Tensor:
    """Fused gather + tiled segment reduction with a monoid per column (one
    kernel launch on the card): ``values`` ``[N, C]`` whose columns are
    ``monoids = (n_sum, n_min, n_max)`` consecutive sum, min and max groups
    -> ``[S, C]`` float32, the identity (0, +inf, -inf) in empty segments."""
    return _segment_reduce(plan, values, plan.gather_padded, monoids)


def segment_reduce(values: torch.Tensor, gather_idx, segment_ids,
                   num_segments: int, op: str = "add",
                   plan: Optional[TilePlan] = None) -> torch.Tensor:
    """General entry point: ``op`` ("add", "min" or "max") over every
    column, through the K1 kernel on ``plan`` (built eagerly on ``values``'
    device when not given)."""
    if op not in _ALL_OF:
        raise ValueError(op)
    if plan is None:
        plan = build_tile_plan(
            np.asarray(gather_idx), np.asarray(segment_ids), num_segments,
            torch_device=values.device,
        )
    cols = 1 if values.dim() == 1 else values.shape[1]
    return _segment_reduce(plan, values, plan.gather_padded, _ALL_OF[op](cols))

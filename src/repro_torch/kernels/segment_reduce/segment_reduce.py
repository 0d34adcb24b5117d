"""Kernel K1: fused gather + tiled segment reduction over a tile plan, with
a monoid (sum, min or max) per column.

The CUDA kernels are in ``csrc/segment_sum.cu`` (its opening note says what
they replace and how they are designed): a narrow route for the window
path's few columns and a wide route, lanes across columns, for the GNN's
rows; :func:`route` picks one by the column count.
:func:`segment_reduce_tiled` launches it for CUDA tensors and takes
:func:`segment_reduce_plain` — ``index_add_`` for the sum columns,
``scatter_reduce`` seeded with the identity for min and max, over the same
plan layout — only for tensors on the CPU.  The plain version is also the
kernels' oracle on the card.  :func:`segment_sum_tiled` is the all-sum case.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build as _build

DEFAULT_TM = 512  # rows per input tile
DEFAULT_TS = 512  # segment ids per output tile

#: the route table: columns at or below NARROW_MAX_C take the narrow route
#: (one warp a range of plan rows, a segmented scan per 4-column chunk), the
#: rest the wide route (lanes across a 128-column tile of each gathered row).
#: The narrow route serves the window path's passes (C = 1-4), ``run_many``
#: (C = 24 / 32), ``wd_plan`` (3 / 24) and ``khop_aggregate`` (32).  The
#: threshold is where the card turns (a sweep by chip_smoke.py's
#: ``kernel:segment_sum_routes``, which now keeps Cora's C = 32-1,433 and
#: ogbn-products' 100 and 128 of it; NVIDIA H100 80GB HBM3, 700.00 W; ms a
#: launch, narrow / wide, CUDA events around single launches):
#:   k-hop pass 1, 7.8 M plan rows: C = 4 0.135 / 0.380, 24 0.250 / 0.384,
#:     32 0.332 / 0.387, 64 0.648 / 0.391;
#:   ogbn-products' SAGE plan, 63.4 M rows: 4 1.09 / 4.46, 24 4.65 / 5.05,
#:     32 5.22 / 5.01, 64 12.56 / 6.33, 100 23.41 / 10.46, 128 29.53 / 11.32;
#:   Cora's GCN plan, 11,264 rows (the host's enqueue sets these below
#:     1,433): 4 0.105 / 0.155, 24 0.155 / 0.101, 32 0.100 / 0.102,
#:     64 0.180 / 0.192, 100 0.099 / 0.102, 128 0.157 / 0.145,
#:     1,433 1.82 / 0.162.
#: So the narrow route keeps the window path's widths (it wins there up to
#: C = 32) and the wide route takes C = 64 and up, where it wins wherever
#: the card, not the host, sets the time.
NARROW_MAX_C = 32
ROUTES = ("narrow", "wide")
#: the narrow route keeps a ``[C]`` float carry per warp, four warps a block,
#: in shared memory; the wide route's registers and shared memory do not
#: grow with C (it has no column limit)
NARROW_SMEM_BYTES = 200 * 1024
#: the wide route's slice of plan rows a work item: a power of two from
#: WIDE_SLICE_MIN to WIDE_SLICE_MAX, the least that keeps the plan's slices
#: to WIDE_SLICES or fewer
WIDE_SLICE_MIN, WIDE_SLICE_MAX, WIDE_SLICES = 32, 1024, 4096

_P = ctypes.c_void_p
_I = ctypes.c_int


def route(channels: int) -> str:
    """The kernel a CUDA launch over ``channels`` columns takes: ``"narrow"``
    (a warp a range of plan rows) or ``"wide"`` (lanes across columns)."""
    return "narrow" if channels <= NARROW_MAX_C else "wide"


def wide_slice_rows(rows: int) -> int:
    """Plan rows a wide-route work item covers, from the plan's row count
    alone (so the order of a segment's combines follows from the plan)."""
    n = WIDE_SLICE_MIN
    while n < WIDE_SLICE_MAX and n * WIDE_SLICES < rows:
        n *= 2
    return n


def _lib():
    lib = _build.load("segment_sum")
    fn = lib.segment_reduce_f32
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I, _I, _I, _P, _P,
                       _P]
        fn.restype = ctypes.c_int
    return fn


def segment_reduce_plain(values: torch.Tensor, gather: Optional[torch.Tensor],
                         seg_tiles: torch.Tensor, *, monoids: Tuple[int, int, int],
                         num_out_tiles: int, ts: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`segment_reduce_tiled`: gather the
    rows, route the pad rows to a sink segment, then ``index_add_`` the sum
    columns and ``scatter_reduce`` (``amin`` / ``amax`` over the identity)
    the min and max columns."""
    n_sum, n_min, n_max = monoids
    sid = seg_tiles.reshape(-1)
    ok = sid >= 0
    rows = values if gather is None else values.index_select(0, gather.long())
    sink = num_out_tiles * ts
    seg = torch.where(ok, sid, sink).long()
    parts = []
    if n_sum:
        src = torch.where(ok[:, None], rows[:, :n_sum],
                          torch.zeros((), dtype=rows.dtype, device=rows.device))
        out = torch.zeros((sink + 1, n_sum), dtype=torch.float32, device=values.device)
        parts.append(out.index_add_(0, seg, src))
    for lo, n, reduce, fill in ((n_sum, n_min, "amin", float("inf")),
                                (n_sum + n_min, n_max, "amax", float("-inf"))):
        if not n:
            continue
        src = torch.where(ok[:, None], rows[:, lo:lo + n],
                          torch.full((), fill, dtype=rows.dtype, device=rows.device))
        out = torch.full((sink + 1, n), fill, dtype=torch.float32, device=values.device)
        parts.append(out.scatter_reduce_(0, seg[:, None].expand_as(src), src,
                                         reduce=reduce, include_self=True))
    if not parts:
        return torch.empty((sink, 0), dtype=torch.float32, device=values.device)
    return torch.cat(parts, dim=1)[:sink]


def segment_reduce_tiled(values: torch.Tensor, gather: Optional[torch.Tensor],
                         seg_tiles: torch.Tensor, m2out: torch.Tensor, *,
                         monoids: Tuple[int, int, int], num_out_tiles: int,
                         tm: int = DEFAULT_TM, ts: int = DEFAULT_TS) -> torch.Tensor:
    """Segment reductions ``[num_out_tiles * ts, C]`` f32 of
    ``values[gather[r]]`` over the plan rows ``r`` (``gather=None``:
    ``values`` holds the pre-gathered ``[Mpad, C]`` rows).  ``monoids =
    (n_sum, n_min, n_max)`` splits the ``C`` columns into consecutive sum,
    min and max groups; an empty segment holds each monoid's identity (0,
    +inf, -inf), and min/max propagate NaN.

    ``values`` is ``[S, C]`` float32; ``gather`` ``[nm * tm]`` and
    ``seg_tiles`` ``[nm, tm]`` (``-1`` on pad rows) and ``m2out`` ``[nm]``
    (non-decreasing) are int32, as :func:`build_tile_plan` lays them out.
    CPU tensors take :func:`segment_reduce_plain`; CUDA tensors launch the
    kernel, and anything the kernel does not take raises.  ``values`` that
    autograd would record raise on either device: the kernel's result
    carries no gradient, and the routes that train (the GNN message passing
    of ``models/gnn.py``) call it inside a ``torch.autograd.Function``.
    A CUDA launch takes :func:`route`'s kernel for ``C``.  Every launch
    adds one to ``segment_sum_tiled.launches`` and to its kernel's
    ``segment_sum_tiled.launches_by_route``."""
    nm = seg_tiles.shape[0]
    dev = values.device
    _build.check_tensor(values, torch.float32, 2, "values")
    _build.check_untracked("segment_reduce_tiled", values)
    _build.check_tensor(seg_tiles, torch.int32, 2, "seg_tiles", dev)
    _build.check_tensor(m2out, torch.int32, 1, "m2out", dev)
    if tuple(seg_tiles.shape) != (nm, tm) or m2out.shape[0] != nm:
        raise ValueError(f"plan shapes disagree: seg_tiles {tuple(seg_tiles.shape)}"
                         f", m2out {tuple(m2out.shape)}, tm={tm}")
    if gather is None:
        if values.shape[0] != nm * tm:
            raise ValueError(f"pre-gathered rows {values.shape[0]} != {nm * tm}")
    else:
        _build.check_tensor(gather, torch.int32, 1, "gather", dev)
        if gather.shape[0] != nm * tm:
            raise ValueError(f"gather rows {gather.shape[0]} != {nm * tm}")
    monoids = tuple(int(x) for x in monoids)
    channels = values.shape[1]
    if len(monoids) != 3 or min(monoids) < 0 or sum(monoids) != channels:
        raise ValueError(f"monoids (n_sum, n_min, n_max) = {monoids} do not "
                         f"split the {channels} columns")
    if _build.plain_route(values):
        return segment_reduce_plain(values, gather, seg_tiles, monoids=monoids,
                                    num_out_tiles=num_out_tiles, ts=ts)
    if dev.type != "cuda" and not _build.is_fake(values):
        raise ValueError(f"segment_reduce_tiled: unsupported device {dev}")
    if nm == 0 or tm % 4:
        raise ValueError(f"the kernel needs at least one input tile and tm % 4 == 0 "
                         f"(nm={nm}, tm={tm})")
    if route(channels) == "narrow" and channels * 16 > NARROW_SMEM_BYTES:
        raise ValueError(f"{channels} columns need more shared memory than a block of "
                         "the narrow route has")
    if channels == 0:
        return torch.empty((num_out_tiles * ts, 0), dtype=torch.float32, device=dev)
    return torch.ops.repro_torch.segment_reduce_tiled(
        values, gather, seg_tiles, m2out, tm, ts, monoids[0], monoids[1], num_out_tiles)


@torch.library.custom_op("repro_torch::segment_reduce_tiled", mutates_args=(),
                         device_types="cuda")
def _launch(values: torch.Tensor, gather: Optional[torch.Tensor], seg_tiles: torch.Tensor,
            m2out: torch.Tensor, tm: int, ts: int, n_sum: int, n_min: int,
            num_out_tiles: int) -> torch.Tensor:
    """One launch on :func:`route`'s kernel (checked inputs); the wide
    route's scratch, a head and a tail partial of C floats a slice, is
    allocated here."""
    for t in (seg_tiles, gather):
        if t is not None and t.data_ptr() % 16:
            raise ValueError("plan index arrays must be 16-byte aligned")
    nm, channels, dev = seg_tiles.shape[0], values.shape[1], values.device
    rows = nm * tm
    out = torch.empty((num_out_tiles * ts, channels), dtype=torch.float32, device=dev)
    kernel = route(channels)
    wide = kernel == "wide"
    slice_rows = wide_slice_rows(rows) if wide else 0
    scratch = (torch.empty(2 * -(-rows // slice_rows) * channels, dtype=torch.float32,
                           device=dev) if wide else None)
    fn = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(values.data_ptr(), None if gather is None else gather.data_ptr(),
                 seg_tiles.data_ptr(), m2out.data_ptr(), rows, tm, ts, channels,
                 n_sum, n_min, slice_rows, scratch.data_ptr() if wide else None,
                 out.data_ptr(), stream)
    _build.check(err, f"segment_reduce_f32 ({kernel})")
    segment_sum_tiled.launches += 1
    segment_sum_tiled.launches_by_route[kernel] += 1
    return out


@_launch.register_fake
def _(values, gather, seg_tiles, m2out, tm, ts, n_sum, n_min, num_out_tiles):
    return values.new_empty((num_out_tiles * ts, values.shape[1]))


@register_flop_formula(torch.ops.repro_torch.segment_reduce_tiled)
def _(values_shape, gather_shape, seg_tiles_shape, *args, **kwargs) -> int:
    # one add (or min, max) a plan row and column
    nm, tm = seg_tiles_shape
    return nm * tm * values_shape[1]


def segment_sum_tiled(values: torch.Tensor, gather: Optional[torch.Tensor],
                      seg_tiles: torch.Tensor, m2out: torch.Tensor, *,
                      num_out_tiles: int, tm: int = DEFAULT_TM,
                      ts: int = DEFAULT_TS) -> torch.Tensor:
    """:func:`segment_reduce_tiled` with every column a sum: segment sums
    ``[num_out_tiles * ts, C]`` f32 (0 in an empty segment)."""
    channels = values.shape[1] if values.dim() == 2 else 0
    return segment_reduce_tiled(values, gather, seg_tiles, m2out,
                                monoids=(channels, 0, 0),
                                num_out_tiles=num_out_tiles, tm=tm, ts=ts)


#: K1 launches so far, whatever the monoids, in all and by route (plain
#: counts; callers may reset them to 0)
segment_sum_tiled.launches = 0
segment_sum_tiled.launches_by_route = {name: 0 for name in ROUTES}

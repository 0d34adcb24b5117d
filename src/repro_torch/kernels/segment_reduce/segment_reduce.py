"""Kernel K1: fused gather + tiled segment sum over a tile plan.

The CUDA kernel is ``csrc/segment_sum.cu`` (its opening note says what it
replaces and how it is designed).  :func:`segment_sum_tiled` launches it for
CUDA tensors and takes :func:`segment_sum_plain` — a masked ``index_add_``
over the same plan layout — only for tensors on the CPU.  The plain version
is also the kernel's oracle on the card.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build as _build

DEFAULT_TM = 512  # rows per input tile
DEFAULT_TS = 512  # segment ids per output tile

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = _build.load("segment_sum")
    fn = lib.segment_sum_f32
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P]
        fn.restype = ctypes.c_int
    return fn


def segment_sum_plain(values: torch.Tensor, gather: Optional[torch.Tensor],
                      seg_tiles: torch.Tensor, *, num_out_tiles: int,
                      ts: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`segment_sum_tiled`: gather the rows,
    zero the pad rows and ``index_add_`` them into a sink-extended output."""
    sid = seg_tiles.reshape(-1)
    ok = sid >= 0
    rows = values if gather is None else values.index_select(0, gather.long())
    rows = torch.where(ok[:, None], rows, torch.zeros((), dtype=rows.dtype,
                                                      device=rows.device))
    sink = num_out_tiles * ts
    out = torch.zeros((sink + 1, values.shape[1]), dtype=torch.float32,
                      device=values.device)
    out.index_add_(0, torch.where(ok, sid, sink).long(), rows)
    return out[:sink]


def segment_sum_tiled(values: torch.Tensor, gather: Optional[torch.Tensor],
                      seg_tiles: torch.Tensor, m2out: torch.Tensor, *,
                      num_out_tiles: int, tm: int = DEFAULT_TM,
                      ts: int = DEFAULT_TS) -> torch.Tensor:
    """Segment sums ``[num_out_tiles * ts, C]`` f32 of ``values[gather[r]]``
    over the plan rows ``r`` (``gather=None``: ``values`` holds the
    pre-gathered ``[Mpad, C]`` rows).

    ``values`` is ``[S, C]`` float32; ``gather`` ``[nm * tm]`` and
    ``seg_tiles`` ``[nm, tm]`` (``-1`` on pad rows) and ``m2out`` ``[nm]``
    (non-decreasing) are int32, as :func:`build_tile_plan` lays them out.
    CPU tensors take :func:`segment_sum_plain`; CUDA tensors launch the
    kernel, and anything the kernel does not take raises."""
    nm = seg_tiles.shape[0]
    _build.check_tensor(values, torch.float32, 2, "values")
    _build.check_tensor(seg_tiles, torch.int32, 2, "seg_tiles", values.device)
    _build.check_tensor(m2out, torch.int32, 1, "m2out", values.device)
    if tuple(seg_tiles.shape) != (nm, tm) or m2out.shape[0] != nm:
        raise ValueError(f"plan shapes disagree: seg_tiles {tuple(seg_tiles.shape)}"
                         f", m2out {tuple(m2out.shape)}, tm={tm}")
    if gather is None:
        if values.shape[0] != nm * tm:
            raise ValueError(f"pre-gathered rows {values.shape[0]} != {nm * tm}")
    else:
        _build.check_tensor(gather, torch.int32, 1, "gather", values.device)
        if gather.shape[0] != nm * tm:
            raise ValueError(f"gather rows {gather.shape[0]} != {nm * tm}")
    if values.device.type == "cpu":
        return segment_sum_plain(values, gather, seg_tiles,
                                 num_out_tiles=num_out_tiles, ts=ts)
    if values.device.type != "cuda":
        raise ValueError(f"segment_sum_tiled: unsupported device {values.device}")
    if 2 * ts * 4 > 227 * 1024:
        raise ValueError(f"ts={ts} needs more shared memory than a block has")
    channels = values.shape[1]
    out = torch.empty((num_out_tiles * ts, channels), dtype=torch.float32,
                      device=values.device)
    if channels == 0 or nm == 0:
        return out.zero_()
    fn = _lib()
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        err = fn(values.data_ptr(), None if gather is None else gather.data_ptr(),
                 seg_tiles.data_ptr(), m2out.data_ptr(), nm, tm, ts,
                 num_out_tiles, channels, out.data_ptr(), stream)
    _build.check(err, "segment_sum_f32")
    segment_sum_tiled.launches += 1
    return out


#: kernel launches so far (a plain count; callers may reset it to 0)
segment_sum_tiled.launches = 0


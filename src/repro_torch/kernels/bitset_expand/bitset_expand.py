"""Kernel K2: one k-hop BFS hop over packed bitsets.

``out[v] = reach[v] | OR{reach[u] : u -> v}`` over the dst-sorted edges in
the segment-sum tile plan's layout.  The CUDA kernel is
``csrc/bitset_expand.cu`` (its opening note says what it replaces and how
it is designed).  :func:`bitset_expand_tiled` launches it for CUDA tensors
and takes :func:`bitset_expand_plain` — a sorted-run OR with
``torch.bitwise_or`` — only for tensors on the CPU.  The plain version is
also the kernel's oracle on the card.

Bitsets are int32 tensors (torch has no ``uint32`` shift on the CPU); the
kernel reads the same words as ``uint32``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as _build

DEFAULT_TM = 256
DEFAULT_TS = 256

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    fn = _build.load("bitset_expand").bitset_expand_u32
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P]
        fn.restype = ctypes.c_int
    return fn


def bitset_expand_plain(reach: torch.Tensor, gather: torch.Tensor,
                        seg_tiles: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`bitset_expand_tiled`.

    The valid plan rows are sorted by destination, so each destination's
    edges form one run.  Pass ``p`` ORs the ``p``-th edge of every run into
    its destination — the destinations of one pass are distinct, so each
    pass is one gather and one ``bitwise_or`` with no colliding writes."""
    sid = seg_tiles.reshape(-1)
    ok = sid >= 0
    dst = sid[ok].long()
    src = gather[ok].long()
    out = reach.clone()
    if dst.numel() == 0:
        return out
    new_run = torch.ones_like(dst, dtype=torch.bool)
    new_run[1:] = dst[1:] != dst[:-1]
    starts = torch.nonzero(new_run).squeeze(1)
    run_len = torch.diff(starts, append=torch.tensor([dst.numel()],
                                                     device=dst.device))
    rank = torch.arange(dst.numel(), device=dst.device) - torch.repeat_interleave(
        starts, run_len)
    order = torch.argsort(rank, stable=True)
    per_pass = torch.bincount(rank).tolist()
    for rows in torch.split(order, per_pass):
        d = dst[rows]
        out[d] = torch.bitwise_or(out[d], reach[src[rows]])
    return out


def bitset_expand_tiled(reach: torch.Tensor, gather: torch.Tensor,
                        seg_tiles: torch.Tensor, m2out: torch.Tensor, *,
                        num_out_tiles: int, tm: int = DEFAULT_TM,
                        ts: int = DEFAULT_TS) -> torch.Tensor:
    """One expansion hop: ``[n, W]`` int32 bitsets -> new ``[n, W]``.

    ``gather`` (edge sources) and ``seg_tiles`` (edge destinations, ``-1``
    on pad rows) are the tile plan of the dst-sorted edges over ``n``
    segments.  CPU tensors take :func:`bitset_expand_plain`; CUDA tensors
    launch the kernel, and anything the kernel does not take raises."""
    nm = seg_tiles.shape[0]
    _build.check_tensor(reach, torch.int32, 2, "reach")
    _build.check_tensor(gather, torch.int32, 1, "gather", reach.device)
    _build.check_tensor(seg_tiles, torch.int32, 2, "seg_tiles", reach.device)
    _build.check_tensor(m2out, torch.int32, 1, "m2out", reach.device)
    n, words = reach.shape
    if (tuple(seg_tiles.shape) != (nm, tm) or m2out.shape[0] != nm
            or gather.shape[0] != nm * tm):
        raise ValueError("plan shapes disagree")
    if n > num_out_tiles * ts:
        raise ValueError(f"{n} rows but the plan covers {num_out_tiles * ts}")
    if reach.device.type == "cpu":
        return bitset_expand_plain(reach, gather, seg_tiles)
    if reach.device.type != "cuda":
        raise ValueError(f"bitset_expand_tiled: unsupported device {reach.device}")
    if words % 4 or reach.data_ptr() % 16:
        raise ValueError("the kernel reads 16-byte words: W must be a "
                         "multiple of 4 and the rows 16-byte aligned")
    out = torch.empty_like(reach)
    if n == 0:
        return out
    fn = _lib()
    with torch.cuda.device(reach.device):
        stream = torch.cuda.current_stream(reach.device).cuda_stream
        err = fn(reach.data_ptr(), gather.data_ptr(), seg_tiles.data_ptr(),
                 m2out.data_ptr(), nm, tm, ts, n, words, out.data_ptr(), stream)
    _build.check(err, "bitset_expand_u32")
    bitset_expand_tiled.launches += 1
    return out


#: kernel launches so far (a plain count; callers may reset it to 0)
bitset_expand_tiled.launches = 0

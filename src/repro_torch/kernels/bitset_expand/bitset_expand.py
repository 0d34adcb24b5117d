"""Kernel K2: one k-hop BFS hop over packed bitsets.

``out[v] = reach[v] | OR{reach[u] : u -> v}`` over the dst-sorted edges in
the segment-sum tile plan's layout.  Beside the words travels an occupancy
mask: bit ``g`` of ``mask[v, g // 32]`` says that words ``4g..4g+3`` of row
``v`` are not all zero (:func:`mask_words` uint32 a row, one per 128
words).  The CUDA kernel reads only the groups a mask marks and writes the
output's mask with the output (``csrc/bitset_expand.cu``; its opening note
says what it replaces and how it is designed).  :func:`bitset_expand_tiled`
launches it for CUDA tensors and takes :func:`bitset_expand_plain` — a
sorted-run OR with ``torch.bitwise_or`` — only for tensors on the CPU; the
plain version is also the kernel's oracle on the card.  :func:`bitset_mask`
computes a mask from the words (the pre-pass kernel on the card).

Bitsets and masks are int32 tensors (torch has no ``uint32`` shift on the
CPU); the kernels read the same words as ``uint32``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build as _build

DEFAULT_TM = 256
DEFAULT_TS = 256
#: destination rows one warp of the kernel serves (``csrc/bitset_expand.cu``
#: ``kRows``): ``ts`` must be a multiple
TILE_ROWS = 8

_P = ctypes.c_void_p
_I = ctypes.c_int


#: the C entry points of ``csrc/bitset_expand.cu`` and their arguments
_ARGTYPES = {
    # reach, mask, gather, row_ptr, pad_before, n, words, ts, out, out_mask, stream
    "bitset_expand_u32": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P],
    # reach, n, words, mask, stream
    "bitset_mask_u32": [_P, _I, _I, _P, _P],
}


def _lib(name: str):
    fn = getattr(_build.load("bitset_expand"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def mask_words(words: int) -> int:
    """Occupancy-mask words a row of ``words`` bitset words: one bit per
    16-byte group of 4 words, 32 groups a mask word."""
    return -(-(words // 4) // 32)


def bitset_mask_plain(reach: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`bitset_mask`."""
    n, words = reach.shape
    nz = (reach.reshape(n, words // 4, 4) != 0).any(dim=2)
    groups = nz.shape[1]
    mw = mask_words(words)
    nz = torch.nn.functional.pad(nz, (0, mw * 32 - groups)).reshape(n, mw, 32)
    bits = nz.to(torch.int64) << torch.arange(32, device=reach.device)
    words_u32 = bits.sum(dim=2)  # each bit once: the sum is the OR
    return torch.where(words_u32 >= 2**31, words_u32 - 2**32, words_u32).to(torch.int32)


def bitset_mask(reach: torch.Tensor) -> torch.Tensor:
    """The occupancy mask ``[n, mask_words(W)]`` int32 of ``[n, W]`` int32
    bitsets.  CPU tensors take :func:`bitset_mask_plain`; CUDA tensors
    launch the pre-pass kernel, and anything it does not take raises."""
    _build.check_tensor(reach, torch.int32, 2, "reach")
    n, words = reach.shape
    if words % 4:
        raise ValueError(f"W = {words}: the masks cover 16-byte groups of 4 words")
    if reach.device.type == "cpu":
        return bitset_mask_plain(reach)
    _check_cuda(reach)
    mask = torch.empty((n, mask_words(words)), dtype=torch.int32, device=reach.device)
    if n == 0:
        return mask
    fn = _lib("bitset_mask_u32")
    with torch.cuda.device(reach.device):
        stream = torch.cuda.current_stream(reach.device).cuda_stream
        err = fn(reach.data_ptr(), n, words, mask.data_ptr(), stream)
    _build.check(err, "bitset_mask_u32")
    bitset_mask.launches += 1
    return mask


#: pre-pass kernel launches so far (a plain count; callers may reset it)
bitset_mask.launches = 0


def _check_cuda(reach: torch.Tensor) -> None:
    if reach.device.type != "cuda":
        raise ValueError(f"bitset_expand: unsupported device {reach.device}")
    _build.check_untracked("bitset_expand", reach)  # int32: never tracked today
    if reach.data_ptr() % 16:
        raise ValueError("the kernels read 16-byte groups: the rows must be "
                         "16-byte aligned")


def bitset_expand_plain(reach: torch.Tensor, gather: torch.Tensor,
                        seg_tiles: torch.Tensor,
                        mask: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`bitset_expand_tiled`: ``(out,
    out_mask)``.  It ORs every word, so it needs no ``mask`` (taken for the
    same signature); the output's mask is computed from its words.

    The valid plan rows are sorted by destination, so each destination's
    edges form one run.  Pass ``p`` ORs the ``p``-th edge of every run into
    its destination — the destinations of one pass are distinct, so each
    pass is one gather and one ``bitwise_or`` with no colliding writes."""
    del mask
    sid = seg_tiles.reshape(-1)
    ok = sid >= 0
    dst = sid[ok].long()
    src = gather[ok].long()
    out = reach.clone()
    if dst.numel():
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
    return out, bitset_mask_plain(out)


def bitset_expand_tiled(reach: torch.Tensor, gather: torch.Tensor,
                        seg_tiles: torch.Tensor, row_ptr: torch.Tensor,
                        pad_before: torch.Tensor, *,
                        mask: Optional[torch.Tensor] = None,
                        num_out_tiles: int, tm: int = DEFAULT_TM,
                        ts: int = DEFAULT_TS) -> Tuple[torch.Tensor, torch.Tensor]:
    """One expansion hop: ``[n, W]`` int32 bitsets -> ``(out, out_mask)``.

    ``gather`` (edge sources) and ``seg_tiles`` (edge destinations, ``-1``
    on pad rows) are the tile plan of the dst-sorted edges over ``n``
    segments; ``row_ptr`` ``[n + 1]`` the CSR offsets of each destination's
    edges among the valid plan rows, ``pad_before`` ``[num_out_tiles]`` the
    pad rows laid out before each output tile's group.  ``mask`` is
    ``reach``'s occupancy mask (:func:`bitset_mask` computes it when not
    given: one more launch on the card); ``out_mask`` is ``out``'s.  CPU
    tensors take :func:`bitset_expand_plain`; CUDA tensors launch the
    kernel, and anything the kernel does not take raises."""
    nm = seg_tiles.shape[0]
    _build.check_tensor(reach, torch.int32, 2, "reach")
    dev = reach.device
    _build.check_tensor(gather, torch.int32, 1, "gather", dev)
    _build.check_tensor(seg_tiles, torch.int32, 2, "seg_tiles", dev)
    _build.check_tensor(row_ptr, torch.int32, 1, "row_ptr", dev)
    _build.check_tensor(pad_before, torch.int32, 1, "pad_before", dev)
    n, words = reach.shape
    if words % 4:
        raise ValueError(f"W = {words}: the kernel reads 16-byte groups of 4 words")
    if (tuple(seg_tiles.shape) != (nm, tm) or gather.shape[0] != nm * tm
            or pad_before.shape[0] != num_out_tiles):
        raise ValueError("plan shapes disagree")
    if row_ptr.shape[0] != n + 1:
        raise ValueError(f"row_ptr has {row_ptr.shape[0]} entries for {n} rows")
    if n > num_out_tiles * ts:
        raise ValueError(f"{n} rows but the plan covers {num_out_tiles * ts}")
    if ts % TILE_ROWS:
        raise ValueError(f"ts = {ts}: the kernel's tiles of {TILE_ROWS} rows must "
                         "not straddle output tiles")
    if mask is not None:
        _build.check_tensor(mask, torch.int32, 2, "mask", dev)
        if tuple(mask.shape) != (n, mask_words(words)):
            raise ValueError(f"mask is {tuple(mask.shape)}, expected "
                             f"{(n, mask_words(words))}")
    if dev.type == "cpu":
        return bitset_expand_plain(reach, gather, seg_tiles, mask)
    _check_cuda(reach)
    if mask is None:
        mask = bitset_mask(reach)
    out = torch.empty_like(reach)
    out_mask = torch.empty_like(mask)
    if n == 0:
        return out, out_mask
    fn = _lib("bitset_expand_u32")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(reach.data_ptr(), mask.data_ptr(), gather.data_ptr(),
                 row_ptr.data_ptr(), pad_before.data_ptr(), n, words, ts,
                 out.data_ptr(), out_mask.data_ptr(), stream)
    _build.check(err, "bitset_expand_u32")
    bitset_expand_tiled.launches += 1
    return out, out_mask


#: kernel launches so far (a plain count; callers may reset it to 0)
bitset_expand_tiled.launches = 0

"""The inheritance scan along the I-Index's PID forest (the level schedule
of paper Algorithm 5), with a monoid (sum, min or max) per column.

The CUDA kernel is ``csrc/inherit_scan.cu`` (its opening note says what it
replaces and how it is designed).  :func:`inherit_scan` launches it for
CUDA tensors and takes :func:`inherit_scan_plain` — the level loop over the
same layout in PyTorch — only for tensors on the CPU.  The plain version is
also the kernel's oracle on the card.  :func:`inherit_scan_doubling` is the
pointer-doubling schedule, plain PyTorch as the reference computes it in
``jnp`` outside any Pallas kernel.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from repro_torch.kernels import build as _build

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    fn = _build.load("inherit_scan").inherit_scan_f32
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P]
        fn.restype = ctypes.c_int
    return fn


def _combine(w: torch.Tensor, p: torch.Tensor, monoids) -> torch.Tensor:
    """Columns of ``w`` and ``p`` combined group by group: ``w + p`` on the
    sum columns, ``torch.minimum`` / ``torch.maximum`` (NaN-propagating, as
    ``jnp.minimum`` / ``jnp.maximum``) on the min and max columns."""
    n_sum, n_min, _ = monoids
    lo = n_sum + n_min
    return torch.cat([w[:, :n_sum] + p[:, :n_sum],
                      torch.minimum(w[:, n_sum:lo], p[:, n_sum:lo]),
                      torch.maximum(w[:, lo:], p[:, lo:])], dim=1)


def _identity_row(monoids, like: torch.Tensor) -> torch.Tensor:
    n_sum, n_min, n_max = monoids
    return torch.tensor([0.0] * n_sum + [math.inf] * n_min + [-math.inf] * n_max,
                        dtype=like.dtype, device=like.device)


def inherit_scan_plain(wdp: torch.Tensor, pid: torch.Tensor, order: torch.Tensor,
                       level_ptr: torch.Tensor, *, max_level: int,
                       monoids: Tuple[int, int, int]) -> torch.Tensor:
    """Plain PyTorch version of :func:`inherit_scan`: level by level, each
    level's vertices combine their partials with their parents' finished
    values.  ``pid`` is clamped explicitly (``jnp.take`` clips, torch
    indexing raises) and the roots, at level 0, keep their partials."""
    out = wdp.clone()
    ptr = level_ptr[: max_level + 2].tolist()
    parent = pid.long().clamp(min=0)
    for lv in range(1, max_level + 1):
        idx = order[ptr[lv]:ptr[lv + 1]].long()
        out[idx] = _combine(wdp[idx], out[parent[idx]], monoids)
    return out


def inherit_scan_doubling(wdp: torch.Tensor, pid: torch.Tensor, *, max_level: int,
                          monoids: Tuple[int, int, int]) -> torch.Tensor:
    """The pointer-doubling schedule: ceil(log2(max_level + 1)) rounds, each
    one gather of the pointers' values and one of the pointers' pointers.
    A vertex whose pointer ran off the forest combines with the identity,
    exactly where the reference does (a sum column's -0.0 becomes +0.0)."""
    n = wdp.shape[0]
    rounds = max(1, math.ceil(math.log2(max_level + 1))) if max_level else 0
    ident = _identity_row(monoids, wdp)
    val, ptr = wdp, pid
    for _ in range(rounds):
        safe = ptr.long().clamp(0, n - 1)
        mask = ptr >= 0
        pv = torch.where(mask[:, None], val[safe], ident)
        val = _combine(val, pv, monoids)
        ptr = torch.where(mask, ptr[safe], -1)
    return val


def inherit_scan(wdp: torch.Tensor, pid: torch.Tensor, order: torch.Tensor,
                 level_ptr: torch.Tensor, *, max_level: int,
                 monoids: Tuple[int, int, int]) -> torch.Tensor:
    """The level schedule over ``wdp`` ``[n, C]`` float32 whose columns are
    ``monoids = (n_sum, n_min, n_max)`` consecutive sum, min and max groups:
    ``out[v] = op(wdp[v], out[pid[v]])`` level by level, the roots keeping
    ``wdp``.  ``pid`` and ``order`` are int32 ``[n]``, ``level_ptr`` int32
    ``[n + 1]`` (level ``L`` is ``order[level_ptr[L]:level_ptr[L + 1]]``),
    and every vertex's level is at most ``max_level``, as
    :func:`~repro_torch.kernels.inherit_scan.ops.level_layout` lays them
    out.  CPU tensors take :func:`inherit_scan_plain`; CUDA tensors launch
    the kernel, and anything the kernel does not take raises.  Every launch
    adds one to ``inherit_scan.launches``."""
    dev = wdp.device
    _build.check_tensor(wdp, torch.float32, 2, "wdp")
    n, channels = wdp.shape
    for t, name, size in ((pid, "pid", n), (order, "order", n),
                          (level_ptr, "level_ptr", n + 1)):
        _build.check_tensor(t, torch.int32, 1, name, dev)
        if t.shape[0] != size:
            raise ValueError(f"{name} has {t.shape[0]} entries, expected {size}")
    monoids = tuple(int(x) for x in monoids)
    if len(monoids) != 3 or min(monoids) < 0 or sum(monoids) != channels:
        raise ValueError(f"monoids (n_sum, n_min, n_max) = {monoids} do not "
                         f"split the {channels} columns")
    max_level = int(max_level)
    if not 0 <= max_level < max(n, 1):
        raise ValueError(f"max_level {max_level} outside [0, {n})")
    if dev.type == "cpu":
        return inherit_scan_plain(wdp, pid, order, level_ptr, max_level=max_level,
                                  monoids=monoids)
    if dev.type != "cuda":
        raise ValueError(f"inherit_scan: unsupported device {dev}")
    out = torch.empty_like(wdp)
    if n == 0 or channels == 0:
        return out
    fn = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(wdp.data_ptr(), pid.data_ptr(), order.data_ptr(), level_ptr.data_ptr(),
                 n, channels, monoids[0], monoids[1], max_level, out.data_ptr(), stream)
    _build.check(err, "inherit_scan_f32")
    inherit_scan.launches += 1
    return out


#: kernel launches so far (a plain count; callers may reset it to 0)
inherit_scan.launches = 0

"""Host layout + schedule dispatch for the inheritance scan.

:func:`level_layout` lays the PID forest's vertices out by level once, at
plan build time (host, NumPy); :func:`inherit` runs one schedule over a
``[n, C]`` partial matrix — the level schedule through the kernel
(:func:`~repro_torch.kernels.inherit_scan.inherit_scan.inherit_scan`, one
launch on the card), the doubling schedule in plain PyTorch.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels.inherit_scan.inherit_scan import (
    inherit_scan,
    inherit_scan_doubling,
)

SCHEDULES = ("level", "doubling")


def level_layout(level: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``(order, level_ptr)``: the vertices stably sorted by level (int32
    ``[n]``) and the level offsets (int32 ``[n + 1]``; level ``L`` is
    ``order[level_ptr[L]:level_ptr[L + 1]]``, and every entry past the
    deepest level is ``n``).  Both shapes depend on ``n`` alone."""
    level = np.asarray(level, np.int64)
    n = level.size
    order = np.argsort(level, kind="stable").astype(np.int32)
    level_ptr = np.zeros(n + 1, np.int32)
    if n:
        np.cumsum(np.bincount(level, minlength=n)[:n], out=level_ptr[1:])
    return order, level_ptr


def inherit(wdp: torch.Tensor, pid: torch.Tensor, order: torch.Tensor,
            level_ptr: torch.Tensor, max_level: int,
            monoids: Tuple[int, int, int], schedule: str = "level") -> torch.Tensor:
    """Every column of ``wdp`` inherited along the PID forest by
    ``schedule`` ("level": the reference's default, one kernel launch on
    the card; "doubling": pointer doubling, plain PyTorch)."""
    if schedule == "level":
        return inherit_scan(wdp, pid, order, level_ptr, max_level=max_level,
                            monoids=monoids)
    if schedule == "doubling":
        return inherit_scan_doubling(wdp, pid, max_level=max_level, monoids=monoids)
    raise ValueError(f"unknown schedule {schedule!r} (have {SCHEDULES})")

"""Host layouts + schedule dispatch for the inheritance scan.

:func:`level_layout` lays the PID forest's vertices out by level, and
:func:`chain_layout` cuts the forest into heavy paths; :func:`forest_layout`
makes both once at plan build time (host, NumPy).  :func:`inherit` runs
one schedule over a ``[n, C]`` partial matrix — the level schedule (on
the card the chain-walk kernel of
:func:`~repro_torch.kernels.inherit_scan.inherit_scan.inherit_scan`, one
launch, which computes the level schedule's values bit for bit; on the
CPU its plain level loop), or the doubling schedule in plain PyTorch.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels.inherit_scan.inherit_scan import (
    ChainLayout,
    Forest,
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


def subtree_sizes(pid: np.ndarray, level: np.ndarray) -> np.ndarray:
    """int64 ``[n]``: each vertex's subtree size in the PID forest, summed
    level by level from the deepest up (one ``np.add.at`` a level)."""
    pid = np.asarray(pid, np.int64)
    order, ptr = level_layout(level)
    order = order.astype(np.int64)
    parent = pid[order]
    size = np.ones(pid.size, np.int64)
    for lv in range(int(np.max(level, initial=0)), 0, -1):
        a, b = ptr[lv], ptr[lv + 1]
        np.add.at(size, parent[a:b], size[order[a:b]])
    return size


def chain_layout(pid: np.ndarray, level: np.ndarray) -> ChainLayout:
    """Heavy-path decomposition of the PID forest (``pid`` int ``[n]``, -1
    for a root; ``level`` each vertex's depth): every vertex's chain goes on
    into its child with the largest subtree (ties: the smallest id), so any
    root-to-leaf path enters at most ``floor(log2 n)`` chains after its
    first.  Chains are ordered by their head's level, then the head's id,
    so each chain's parent lies in an earlier chain: the order in which the
    chain-walk kernel claims them."""
    pid = np.asarray(pid, np.int64)
    level = np.asarray(level, np.int64)
    n = pid.size
    size = subtree_sizes(pid, level)
    child = np.flatnonzero(pid >= 0)
    # per parent, its children by size (largest first), then by id
    by = child[np.lexsort((child, -size[child], pid[child]))]
    first = np.ones(by.size, bool)
    first[1:] = pid[by[1:]] != pid[by[:-1]]
    head = np.ones(n, bool)
    head[by[first]] = False  # a heavy child continues its parent's chain
    # each vertex's chain head, by pointer doubling up the heavy edges
    top = np.where(head, np.arange(n), pid)
    while not head[top].all():
        top = top[top]
    heads = np.flatnonzero(head)
    heads = heads[np.lexsort((heads, level[heads]))]
    count = heads.size
    rank = np.empty(n, np.int64)
    rank[heads] = np.arange(count)
    vertices = np.lexsort((level, rank[top])).astype(np.int32)
    ptr = np.full(n + 1, n, np.int32)
    ptr[0] = 0
    np.cumsum(np.bincount(rank[top], minlength=count), out=ptr[1:count + 1])
    pos = np.empty(n, np.int64)
    pos[vertices] = np.arange(n)
    head_parent = np.full(n, -1, np.int32)
    hp = pid[heads]
    head_parent[:count] = np.where(hp >= 0, pos[np.maximum(hp, 0)], -1)
    return ChainLayout(vertices, ptr, head_parent, int(count))


def forest_layout(pid: np.ndarray, level: np.ndarray) -> Forest:
    """The PID forest (``pid`` int ``[n]``, -1 for a root; ``level`` each
    vertex's depth) in both of the scan's layouts, as host int32 arrays."""
    order, level_ptr = level_layout(level)
    return Forest(np.asarray(pid, np.int32), order, level_ptr,
                  int(np.max(level, initial=0)), chain_layout(pid, level))


def inherit(wdp: torch.Tensor, forest: Forest, monoids: Tuple[int, int, int],
            schedule: str = "level") -> torch.Tensor:
    """Every column of ``wdp`` inherited along ``forest`` by ``schedule``
    ("level": the reference's default, one kernel launch over the chain
    layout on the card; "doubling": pointer doubling, plain PyTorch)."""
    if schedule == "level":
        return inherit_scan(wdp, forest, monoids=monoids)
    if schedule == "doubling":
        return inherit_scan_doubling(wdp, forest.pid, max_level=forest.max_level,
                                     monoids=monoids)
    raise ValueError(f"unknown schedule {schedule!r} (have {SCHEDULES})")

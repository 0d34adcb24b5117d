"""The inheritance scan along the I-Index's PID forest (the level schedule
of paper Algorithm 5), with a monoid (sum, min or max) per column.

The CUDA kernel is ``csrc/inherit_scan.cu`` (its opening note says what it
replaces and how it is designed): it walks the forest's heavy paths
(:class:`ChainLayout`) and gives the level schedule's values bit for bit.
:func:`inherit_scan` takes the forest in both layouts (:class:`Forest`),
launches the kernel for CUDA tensors and takes :func:`inherit_scan_plain`
— the level loop over the level layout in PyTorch — only for tensors on
the CPU.  The plain version is also the kernel's oracle on the card.
:func:`inherit_scan_doubling` is the pointer-doubling schedule, plain
PyTorch as the reference computes it in ``jnp`` outside any Pallas kernel.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import build as _build

_P = ctypes.c_void_p
_I = ctypes.c_int
WARP = 32  # the most columns a warp carries down a chain


def _check_arrays(named, dev) -> None:
    """Raise unless each ``(array, name, size)`` is an int32 vector of
    ``size`` entries on ``dev``."""
    for t, name, size in named:
        _build.check_tensor(t, torch.int32, 1, name, dev)
        if t.shape[0] != size:
            raise ValueError(f"{name} has {t.shape[0]} entries, expected {size}")


class ChainLayout(NamedTuple):
    """The PID forest cut into chains (NumPy arrays or tensors; shapes by
    ``n`` alone): chain ``k`` is ``vertices[ptr[k]:ptr[k + 1]]``, head to
    tail, each vertex the parent of the next; ``head_parent[k]`` is the
    position in ``vertices`` of the head's parent (-1 for a root); every
    chain's parent lies in an earlier chain.  ``ptr`` entries past the last
    chain are ``n``, ``head_parent`` entries -1."""

    vertices: object  # int32 [n]
    ptr: object  # int32 [n + 1]
    head_parent: object  # int32 [n]
    count: int

    def clone(self) -> "ChainLayout":
        """The same layout in fresh storage (tensors only)."""
        return ChainLayout(*(t.clone() for t in self[:3]), self.count)

    def check(self, n: int, dev) -> None:
        """Raise unless the layout's tensors fit ``n`` vertices on ``dev``."""
        _check_arrays([(self.vertices, "chains.vertices", n), (self.ptr, "chains.ptr", n + 1),
                       (self.head_parent, "chains.head_parent", n)], dev)
        if not min(n, 1) <= int(self.count) <= n:
            raise ValueError(f"chains.count {self.count} outside [{min(n, 1)}, {n}]")


class Forest(NamedTuple):
    """The PID forest in the scan's two layouts (NumPy arrays or tensors;
    shapes by ``n`` alone).  The level layout — ``pid`` (-1 for a root),
    ``order`` (the vertices stably sorted by level), ``level_ptr`` (level
    ``L`` is ``order[level_ptr[L]:level_ptr[L + 1]]``, entries past the
    deepest level ``n``) and ``max_level`` (data) — is what the plain level
    loop walks; ``chains`` is what the kernel walks."""

    pid: object  # int32 [n]
    order: object  # int32 [n]
    level_ptr: object  # int32 [n + 1]
    max_level: int
    chains: ChainLayout

    def arrays(self) -> tuple:
        """The six ``[n]``-shaped arrays: the level layout's, then the chains'."""
        return (self.pid, self.order, self.level_ptr, *self.chains[:3])

    def map(self, fn) -> "Forest":
        """The same forest with ``fn`` applied to each of its arrays."""
        pid, order, level_ptr, *chains = map(fn, self.arrays())
        return Forest(pid, order, level_ptr, self.max_level,
                      ChainLayout(*chains, self.chains.count))

    def clone(self) -> "Forest":
        """The same forest in fresh storage (tensors only)."""
        return self.map(lambda t: t.clone())

    def check_levels(self, n: int, dev) -> None:
        """Raise unless the level layout fits ``n`` vertices on ``dev``."""
        _check_arrays([(self.pid, "pid", n), (self.order, "order", n),
                       (self.level_ptr, "level_ptr", n + 1)], dev)
        if not 0 <= int(self.max_level) < max(n, 1):
            raise ValueError(f"max_level {self.max_level} outside [0, {n})")


def _lib():
    fn = _build.load("inherit_scan").inherit_scan_f32
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P]
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


def inherit_scan(wdp: torch.Tensor, forest: Forest, *,
                 monoids: Tuple[int, int, int]) -> torch.Tensor:
    """The level schedule over ``wdp`` ``[n, C]`` float32 whose columns are
    ``monoids = (n_sum, n_min, n_max)`` consecutive sum, min and max groups:
    ``out[v] = op(wdp[v], out[pid[v]])`` from the roots down, the roots
    keeping ``wdp``.  ``forest`` is the PID forest's :class:`Forest`, as
    :func:`~repro_torch.kernels.inherit_scan.ops.forest_layout` lays it
    out, its tensors on ``wdp``'s device.  CPU tensors take
    :func:`inherit_scan_plain`, which reads the level layout; CUDA tensors
    launch the chain-walk kernel, which reads the chain layout; each path
    checks the layout it reads, and anything it does not take raises.
    Every launch adds one to ``inherit_scan.launches``."""
    dev = wdp.device
    _build.check_tensor(wdp, torch.float32, 2, "wdp")
    n, channels = wdp.shape
    monoids = tuple(int(x) for x in monoids)
    if len(monoids) != 3 or min(monoids) < 0 or sum(monoids) != channels:
        raise ValueError(f"monoids (n_sum, n_min, n_max) = {monoids} do not "
                         f"split the {channels} columns")
    if dev.type == "cpu":
        forest.check_levels(n, dev)
        return inherit_scan_plain(wdp, forest.pid, forest.order, forest.level_ptr,
                                  max_level=int(forest.max_level), monoids=monoids)
    if dev.type != "cuda":
        raise ValueError(f"inherit_scan: unsupported device {dev}")
    _build.check_untracked("inherit_scan", wdp)
    chains = forest.chains
    chains.check(n, dev)
    out = torch.empty_like(wdp)
    if n == 0 or channels == 0:
        return out
    # the claim ticket, then one ready flag per (column group, chain position);
    # the kernel's entry point zeroes it on the stream before the launch
    work = torch.empty(1 + (channels + WARP - 1) // WARP * n, dtype=torch.int32, device=dev)
    fn = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(wdp.data_ptr(), chains.vertices.data_ptr(), chains.ptr.data_ptr(),
                 chains.head_parent.data_ptr(), n, channels, monoids[0], monoids[1],
                 int(chains.count), work.data_ptr(), out.data_ptr(), stream)
    _build.check(err, "inherit_scan_f32")
    inherit_scan.launches += 1
    return out


#: kernel launches so far (a plain count; callers may reset it to 0)
inherit_scan.launches = 0

"""Peaks of one NVIDIA H100 SXM and the least time a piece of work needs.

``HBM_BYTES_PER_S``, ``F32_OPS_PER_S`` and ``bound_ms`` are copied from
``chip_smoke.py`` (the repo's on-card smoke script), unchanged.  The rates
are the data sheet's, at the card's full power limit of 700 W.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores


def bound_ms(bytes_moved: int, ops: int, peak: float = F32_OPS_PER_S) -> tuple:
    """(least ms, what bounds it): the larger of the bytes over the memory
    rate and the operations over ``peak`` (operations per second)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def query_bytes(batch: int, n: int, n_aggregates: int) -> int:
    """The bytes a batched window query cannot avoid on the card: each of
    the ``batch x n`` values read once as float32, and each of the
    ``n_aggregates`` ``[batch, n]`` float32 results written once.  They
    come from the query's inputs and outputs alone, so the count is the
    same whatever index, plan or kernel computes the query.  No operation
    count goes beside it: the adds a window aggregate needs depend on the
    graph, not on the query's inputs and outputs."""
    return 4 * batch * n * (1 + n_aggregates)


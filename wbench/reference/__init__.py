"""The plain reference: each vertex's window worked out again from the
benchmark's own edge arrays, and the five aggregates over it.

Plain NumPy and PyTorch only.  Nothing here imports the program under test
(``repro_torch``), the JAX package or JAX, and nothing takes what the
program made: the harness hands in the edge arrays and the values it
generated itself, and the program's results only to be judged.

One module per window kind, found by the name a configuration's
``reference`` key gives (``khop``, ``topo``).  Each has ``prepare(graph,
window, device)``, which materialises the windows, and ``reduce(prepared,
x, dtype)``, which returns the window sum, count, min and max of every
column of ``x`` (``[n, B]``) in ``dtype``.
"""

from __future__ import annotations

import importlib

import torch

#: the aggregates the reference finalises, in the order of their names
AGGREGATES = ("sum", "count", "avg", "min", "max")


def module(kind: str):
    """The reference module of window kind ``kind``."""
    return importlib.import_module(f"wbench.reference.{kind}")


def aggregates(kind: str, prepared, values: torch.Tensor, dtype) -> dict:
    """Every aggregate of ``AGGREGATES`` over each vertex's window, for each
    row of ``values`` (``[B, n]``), each ``[B, n]`` in ``dtype``: the
    reference at float64, the control at a lower precision."""
    x = values.to(dtype).t().contiguous()
    parts = module(kind).reduce(prepared, x, dtype)
    out = {a: parts[a].t() for a in ("sum", "count", "min", "max")}
    out["avg"] = out["sum"] / out["count"]
    return out

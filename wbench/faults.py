"""Faults planted under the port's ``Session``, where the answer is made:
the check's own test drives a run over each and has to see ``correct``
come out false.

* ``stale``: the executor hands back the previous request's answer, as a
  step that returns its state unchanged would;
* ``half``: half of the batch left out, its rows answered from the rest;
* ``altered``: one answer altered where it is produced (one vertex's sum
  for one attribute vector, by 1).

A cell on one card has no exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib

import torch

KINDS = ("stale", "half", "altered")


@contextlib.contextmanager
def planted(kind: str, engine: str):
    """Replace the fused ``run_many`` executor of ``engine`` by its broken
    twin of ``kind`` while the context lasts."""
    from repro_torch.core import api

    real = api._FUSED_MANY[engine]
    last = []

    def stale(plan, vb, aggs):
        fresh = real(plan, vb, aggs)
        out = last[0] if last else fresh
        last[:] = [fresh]
        return out

    def half(plan, vb, aggs):
        h = max(1, len(vb) // 2)
        outs = real(plan, vb[:h], aggs)
        return tuple(torch.cat([o, o[:len(vb) - h]]) for o in outs)

    def altered(plan, vb, aggs):
        outs = real(plan, vb, aggs)
        outs[0][0, 0] += 1
        return outs

    api._FUSED_MANY[engine] = {"stale": stale, "half": half, "altered": altered}[kind]
    try:
        yield
    finally:
        api._FUSED_MANY[engine] = real

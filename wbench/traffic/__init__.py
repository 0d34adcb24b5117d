"""Traffic drivers, one module a loop kind, found by the name a mix's
``loop`` key gives (``wbench/traffic/<loop>.py``).

Each module has one entry, ``make(cell, graph, rng)``: it makes the
traffic's data from the run's seed stream ``rng`` in set-up and returns a
driver with

* ``warm_up(system, count)``: ``count`` requests over the shapes the
  window uses; their seconds;
* ``window(system, seconds, keep, sample_rng, out)``: the measured window,
  a :class:`Window`, with ``keep`` requests drawn by ``sample_rng`` for
  the check;
* ``profile(system, count)``: the calls of ``count`` requests that follow
  the window, for the traced stretch;
* ``values(key)``: the ``[B, n]`` values of a kept request, for the
  reference.

A driver calls the system by the method that the mix's ``request`` key
names.  Nothing is made, built or compiled inside the window.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import List


@dataclasses.dataclass
class Window:
    latencies_s: List[float]
    window_s: float
    attempted: int
    failed: int
    #: the requests kept for the check: (request number, key of its values
    #: for ``values``, results)
    samples: List[tuple]


def module(loop: str):
    """The traffic driver module of loop kind ``loop``."""
    return importlib.import_module(f"wbench.traffic.{loop}")

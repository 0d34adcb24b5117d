"""A closed loop of one client: each request is the mix's ``request`` on
the next ``[batch, n]`` batch of a pool of ``pool`` batches, made from the
seed in set-up and cycled, and ends when the system has handed back every
aggregate as a host array.

Mix keys: ``clients`` (1), ``request``, ``batch``, ``pool``; the values are
integers in the configuration's ``attribute`` range and type.
"""

from __future__ import annotations

import sys
import time
import traceback

import numpy as np

from wbench.traffic import Window


class Closed:
    def __init__(self, mix: dict, attribute: dict, n: int, rng: np.random.Generator):
        if mix["clients"] != 1:
            raise ValueError(f"mix {mix['name']!r}: a closed loop here has one client")
        self.request = mix["request"]
        self.pool = rng.integers(attribute["low"], attribute["high"],
                                 (mix["pool"], mix["batch"], n)).astype(attribute["dtype"])
        #: requests sent so far; request ``i`` sends pool row ``i % pool``
        self.sent = 0

    def values(self, key: int) -> np.ndarray:
        return self.pool[key]

    def _next(self) -> int:
        row = self.sent % len(self.pool)
        self.sent += 1
        return row

    def warm_up(self, system, count: int) -> list:
        call, out = getattr(system, self.request), []
        for _ in range(count):
            t = time.perf_counter()
            call(self.pool[self._next()])
            out.append(time.perf_counter() - t)
        return out

    def window(self, system, seconds: float, keep: int, sample_rng: np.random.Generator,
               out=sys.stderr) -> Window:
        """Requests back to back for ``seconds``; every latency, and
        ``keep`` requests drawn over all of them (reservoir sampling).  A
        request that raises counts as failed."""
        call, lat, samples = getattr(system, self.request), [], []
        attempted = failed = 0
        t_start = time.perf_counter()
        while True:
            row = self._next()
            t0 = time.perf_counter()
            try:
                res = call(self.pool[row])
            except Exception:  # noqa: BLE001  (the window counts it and goes on)
                failed += 1
                if failed == 1:
                    traceback.print_exc(file=out)
                res = None
            t1 = time.perf_counter()
            lat.append(t1 - t0)
            if res is not None:
                if len(samples) < keep:
                    samples.append((attempted, row, res))
                else:
                    j = int(sample_rng.integers(0, attempted + 1))
                    if j < keep:
                        samples[j] = (attempted, row, res)
            attempted += 1
            if t1 - t_start >= seconds:
                return Window(lat, t1 - t_start, attempted, failed, samples)

    def profile(self, system, count: int) -> list:
        call = getattr(system, self.request)
        return [lambda r=self._next(): call(self.pool[r]) for _ in range(count)]


def make(cell, graph, rng: np.random.Generator) -> Closed:
    return Closed(cell.mix, cell.config["attribute"], graph.n, rng)

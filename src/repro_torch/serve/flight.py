"""Bounded flight recorder for the serving tier.

A :class:`FlightRecorder` is a fixed-capacity ring of structured events —
admit / shed / flush / WAL-commit / patch / flip, each stamped with a
sequence number, a wall-relative timestamp, and the MVCC version in play —
so when a ticket fails the service can dump the *recent causal history*
(what was admitted, what was shed, which version flipped when) instead of
a bare exception.

Design constraints, in order:

* **cheap enough to stay on** — one dict build plus a ``deque.append``
  per event (appends are thread-safe under the GIL; no lock on the hot
  path), so the obs-overhead budget (< 5%) holds with the recorder
  enabled.  Unlike metrics/tracing it is *not* gated on ``obs.enable()``:
  a flight record is a crash artifact, and crashes do not schedule
  themselves for instrumented runs.
* **bounded** — ``capacity`` events, oldest evicted first; ``dropped``
  counts evictions so a dump says how much history it is missing.
* **structured** — events are plain dicts (JSON-able as-is) with a fixed
  vocabulary of ``event`` values; see :data:`EVENT_TYPES`.

``dump()`` returns the events newest-last; ``dump_json(path)`` writes
them to disk (the CI failure-artifact hook collects these).
"""

from __future__ import annotations

import json
import threading
import time
import weakref
from collections import deque
from typing import Dict, List, Optional

__all__ = ["FlightRecorder", "EVENT_TYPES", "all_recorders"]

#: the closed event vocabulary:
#: admit      — a request ticket entered the queue (cls, ticket, version)
#: shed       — admission control dropped a ticket (cls, reason)
#: flush      — a micro-batch launched (reason, tickets, served, failed)
#: wal_commit — an UpdateBatch was appended to the WAL (version, records)
#: patch      — index/plan state patched for one state key (key, version,
#:              affected, reorganized)
#: flip       — the serving head moved to a new MVCC version (version)
#: failure    — a ticket finished with an error (cls, error)
#: audit      — shadow-oracle mismatch on a served sample (spec, vertex,
#:              version, expected, got — hex bytes)
#: scrub      — at-rest CRC failure in a sealed WAL record (version,
#:              offset, detail)
#: divergence — follower digest disagreed with the leader's (version,
#:              wal_offset, detail)
EVENT_TYPES = ("admit", "shed", "flush", "wal_commit", "patch", "flip",
               "failure", "audit", "scrub", "divergence")

# every live recorder, for the CI failure-artifact hook: a test that never
# touched the service it built can still dump whatever flew this process
_RECORDERS: "weakref.WeakSet" = weakref.WeakSet()


def all_recorders() -> List["FlightRecorder"]:
    """Every live recorder in the process (weakly tracked)."""
    return list(_RECORDERS)


class FlightRecorder:
    """Fixed-capacity ring of structured serving events."""

    def __init__(self, capacity: int = 256, clock=time.perf_counter):
        self._events: deque = deque(maxlen=int(capacity))
        self._seq_lock = threading.Lock()
        self._seq = 0
        self._clock = clock
        self._epoch = clock()
        #: wall-clock time of the epoch: ``anchor_unix_s + t_s`` converts
        #: an event's relative stamp to Unix time, correlating flight
        #: records with trace and metric timestamps
        self.anchor_unix_s = time.time()
        self.dropped = 0
        _RECORDERS.add(self)

    @property
    def capacity(self) -> int:
        return self._events.maxlen

    def record(self, event: str, **fields) -> None:
        """Append one event.  ``event`` should be from :data:`EVENT_TYPES`
        (unknown types are recorded anyway — forward compatibility beats
        dropping evidence)."""
        with self._seq_lock:
            self._seq += 1
            seq = self._seq
            if len(self._events) == self._events.maxlen:
                self.dropped += 1
        ev = {"seq": seq, "t_s": self._clock() - self._epoch,
              "event": event}
        ev.update(fields)
        self._events.append(ev)

    def __len__(self) -> int:
        return len(self._events)

    def dump(self) -> List[Dict]:
        """The retained events, oldest first (each a JSON-able dict)."""
        return list(self._events)

    def dump_json(self, path) -> str:
        """Write ``{"dropped": N, "anchor_unix_s": T, "events": [...]}``
        to ``path`` (``anchor_unix_s + event["t_s"]`` is Unix time)."""
        with open(path, "w") as f:
            json.dump({"dropped": self.dropped,
                       "anchor_unix_s": self.anchor_unix_s,
                       "events": self.dump()},
                      f, indent=2, default=str)
        return str(path)

    def clear(self) -> None:
        self._events.clear()

    def tail(self, n: int = 32) -> List[Dict]:
        """The most recent ``n`` events (for inline failure dumps)."""
        evs = self.dump()
        return evs[-n:]

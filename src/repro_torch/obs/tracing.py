"""Span-based request tracing with a Chrome ``trace_event`` exporter.

A :class:`Tracer` records the lifecycle of work as **spans** — named,
timed intervals with parent/child links.  Two shapes:

* ``with tracer.span("flush", pending=12):`` — synchronous spans nest via
  a per-thread stack, so the parent link is implicit and a flush that
  launches three groups which each run two term queries shows up as a
  three-level tree.
* ``sp = tracer.start_span("request", detached=True)`` … ``sp.finish()``
  — detached spans for work that crosses threads (a ticket is submitted
  on a client thread and completed by the flusher); they never touch the
  stack, and the caller may pass ``parent=`` explicitly.

Completed spans land in a **ring buffer** (``collections.deque(maxlen)``,
append is thread-safe under the GIL), so a long-running service keeps the
most recent window of activity at O(1) cost and bounded memory.

Export is Chrome ``trace_event`` JSON (the ``chrome://tracing`` /
Perfetto format): each span is one complete ``"ph": "X"`` event with
``ts``/``dur`` in microseconds, and ``args`` carrying ``span_id`` /
``parent_id`` plus any user args, so tooling that doesn't infer nesting
from timestamps can still reconstruct the tree.  :meth:`Tracer.dump`
writes a loadable file; :meth:`Tracer.max_depth` reports the deepest
parent chain (the demo asserts >= 4 levels across
request → flush → launch → maintenance).

:class:`NullTracer` is the compile-out twin: ``span`` returns one shared
re-entrant no-op context manager, so un-enabled tracing costs one method
call per span site.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

__all__ = ["Span", "Tracer", "NullTracer"]


class Span:
    """One open interval.  ``set(**args)`` attaches data mid-flight;
    ``finish()`` records it (idempotent).  Prefer ``tracer.span(...)`` —
    the context-manager form — unless the span crosses threads."""

    __slots__ = ("tracer", "id", "parent_id", "name", "cat", "t0", "args",
                 "tid", "_on_stack", "_done")

    def __init__(self, tracer: "Tracer", span_id: int,
                 parent_id: Optional[int], name: str, cat: str,
                 args: Dict, on_stack: bool):
        self.tracer = tracer
        self.id = span_id
        self.parent_id = parent_id
        self.name = name
        self.cat = cat
        self.args = args
        self.t0 = tracer._now()
        self.tid = threading.get_ident()
        self._on_stack = on_stack
        self._done = False

    def set(self, **args) -> "Span":
        self.args.update(args)
        return self

    def finish(self) -> None:
        if self._done:
            return
        self._done = True
        self.tracer._record(self)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.args.setdefault("error", exc_type.__name__)
        if self._on_stack:
            self.tracer._pop(self)
        self.finish()


class Tracer:
    """Ring-buffered span recorder.  ``capacity`` bounds retained events;
    the oldest fall off first.  All methods are thread-safe."""

    def __init__(self, capacity: int = 65536):
        self._events: deque = deque(maxlen=int(capacity))
        self._ids = itertools.count(1)  # C-level next(): thread-safe
        self._tls = threading.local()
        self._epoch = time.perf_counter()
        self.dropped_hint = 0  # events appended beyond capacity (approx.)
        # recorded thread names, by ident: threads register themselves via
        # name_thread() so the export stays legible even after they exit
        # (threading.enumerate() only sees live threads)
        self._thread_names: Dict[int, str] = {}

    # ------------------------------------------------------------------ #
    def _now(self) -> float:
        return time.perf_counter() - self._epoch

    def _stack(self) -> List[Span]:
        try:
            return self._tls.stack
        except AttributeError:
            s = self._tls.stack = []
            return s

    def span(self, name: str, cat: str = "repro", **args) -> Span:
        """Open a nested span (parent = the thread's innermost open span).
        Use as a context manager."""
        stack = self._stack()
        parent = stack[-1].id if stack else None
        sp = Span(self, next(self._ids), parent, name, cat, args,
                  on_stack=True)
        stack.append(sp)
        return sp

    def start_span(self, name: str, cat: str = "repro",
                   parent: Optional[int] = None, **args) -> Span:
        """Open a detached span (cross-thread lifecycle; finish manually).
        ``parent`` links it explicitly; it never joins the thread stack."""
        return Span(self, next(self._ids), parent, name, cat, args,
                    on_stack=False)

    def name_thread(self, name: Optional[str] = None,
                    tid: Optional[int] = None) -> None:
        """Register a thread's display name for the Chrome export (a
        ``"ph": "M"`` metadata row in Perfetto).  Call with no arguments
        from a worker's run loop to self-register under its
        ``threading.Thread`` name — flusher, replica-tail, scrubber and
        auditor threads all do."""
        if tid is None:
            tid = threading.get_ident()
        if name is None:
            name = threading.current_thread().name
        self._thread_names[int(tid)] = str(name)

    def instant(self, name: str, cat: str = "repro", **args) -> None:
        """A zero-duration marker event."""
        if len(self._events) == self._events.maxlen:
            self.dropped_hint += 1
        self._events.append({
            "name": name, "cat": cat, "ph": "i", "s": "t",
            "ts": self._now() * 1e6, "pid": os.getpid(),
            "tid": threading.get_ident(), "args": args,
        })

    # ------------------------------------------------------------------ #
    def _pop(self, sp: Span) -> None:
        stack = self._stack()
        if stack and stack[-1] is sp:
            stack.pop()
        elif sp in stack:  # tolerate out-of-order exits
            stack.remove(sp)

    def _record(self, sp: Span) -> None:
        if len(self._events) == self._events.maxlen:
            self.dropped_hint += 1
        args = dict(sp.args)
        args["span_id"] = sp.id
        if sp.parent_id is not None:
            args["parent_id"] = sp.parent_id
        self._events.append({
            "name": sp.name, "cat": sp.cat, "ph": "X",
            "ts": sp.t0 * 1e6, "dur": (self._now() - sp.t0) * 1e6,
            "pid": os.getpid(), "tid": sp.tid, "args": args,
        })

    # ------------------------------------------------------------------ #
    def events(self) -> List[Dict]:
        return list(self._events)

    def __len__(self) -> int:
        return len(self._events)

    def clear(self) -> None:
        self._events.clear()

    def max_depth(self) -> int:
        """Deepest recorded parent chain (1 = only root spans)."""
        evs = [e for e in self._events if e["ph"] == "X"]
        parent = {e["args"]["span_id"]: e["args"].get("parent_id")
                  for e in evs}
        best = 0
        for sid in parent:
            d, cur = 0, sid
            while cur is not None and d <= len(parent):
                d += 1
                cur = parent.get(cur)
            best = max(best, d)
        return best

    def chrome_trace(self) -> Dict:
        """The Chrome/Perfetto ``trace_event`` JSON object."""
        evs = self.events()
        # thread-name metadata rows make the viewer legible: live threads
        # from the runtime, overlaid by name_thread() registrations (the
        # recorded name survives the thread — and wins, since a worker
        # knows its role better than a default "Thread-7")
        names = {}
        for th in threading.enumerate():
            names[th.ident] = th.name
        names.update(self._thread_names)
        meta = [{"name": "process_name", "ph": "M", "pid": os.getpid(),
                 "tid": 0, "args": {"name": "repro-serving"}}]
        meta += [
            {"name": "thread_name", "ph": "M", "pid": os.getpid(),
             "tid": tid, "args": {"name": names.get(tid, f"thread-{tid}")}}
            for tid in sorted({e["tid"] for e in evs}
                              | set(self._thread_names))
        ]
        return {"traceEvents": meta + evs, "displayTimeUnit": "ms"}

    def dump(self, path) -> str:
        """Write the Chrome trace JSON to ``path``; returns the path."""
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return os.fspath(path)


# ---------------------------------------------------------------------- #
class _NullSpan:
    """Shared no-op span/context-manager.  Re-entrant and stateless, so a
    single instance serves every call site and thread."""

    __slots__ = ()
    id = None
    parent_id = None

    def set(self, **args) -> "_NullSpan":
        return self

    def finish(self) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NULL_SPAN = _NullSpan()


class NullTracer:
    """No-op tracer (the default): every span site costs one method call
    returning the shared null span."""

    enabled = False
    dropped_hint = 0

    def span(self, name: str, cat: str = "repro", **args) -> _NullSpan:
        return _NULL_SPAN

    def start_span(self, name: str, cat: str = "repro", parent=None,
                   **args) -> _NullSpan:
        return _NULL_SPAN

    def instant(self, name: str, cat: str = "repro", **args) -> None:
        pass

    def name_thread(self, name=None, tid=None) -> None:
        pass

    def events(self) -> List:
        return []

    def __len__(self) -> int:
        return 0

    def clear(self) -> None:
        pass

    def max_depth(self) -> int:
        return 0

    def chrome_trace(self) -> Dict:
        return {"traceEvents": [], "displayTimeUnit": "ms"}

    def dump(self, path) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return os.fspath(path)


Tracer.enabled = True

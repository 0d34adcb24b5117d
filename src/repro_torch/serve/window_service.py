"""Window-analytics serving layer: scheduler + versioned reads + result cache.

The paper's index makes ONE window query ~1e4x faster; this layer turns
that into a *service*: many concurrent callers issuing point-vertex and
full-graph reads against a live update stream, without blocking reads on
writes and without ever re-specializing the fused executor.  It fronts a
:class:`repro_torch.core.api.Session` with three mechanisms:

* **Micro-batching scheduler** — requests queue in :meth:`WindowService.
  submit` and :meth:`~WindowService.flush` coalesces them per (window,
  attr) plan group into padded ``run_group_many`` calls at a fixed batch
  bucket.  The [bucket, n] batch never reshapes, so every flush is one
  fused query of one shape per group (on the k-hop DBIndex plan, two K1
  launches; :func:`repro_torch.core.api.recompile_count` stays flat).

* **Versioned snapshot reads** — the service keeps one *active*
  :class:`~repro_torch.core.api.SessionView` for readers;
  :meth:`~WindowService.update` streams batches into the write head while
  reads keep answering at the pinned version v, and
  :meth:`~WindowService.flip` publishes v+1 with one reference swap.  The
  session patches device plans in place, so an update first clones a plan
  that a live view holds (copy-on-write) and patches the clone: no reader
  ever launches on a half-patched plan.

* **Affected-owner result cache** — :class:`AffectedOwnerCache` holds one
  full result vector per (window, agg, attr) at vertex granularity.  An
  update invalidates ONLY the affected-owner set the batched index
  maintenance already computed (paper §4.3's locality: every other
  vertex's window provably did not change), so steady-state point traffic
  is an O(1) hit and an update costs ~|affected| invalidations instead of
  a full cache flush.  The first post-update miss refreshes the whole
  group vector with one fused query.

:class:`AsyncWindowService` adds the continuous-batching front end on
top: a background flusher launches a bucket when it *fills* or when the
earliest request's latency **deadline** expires (``max_delay_ms`` per
:class:`RequestClass`); admission control sheds the lowest-priority
sheddable full-graph scans first (never point reads) and applies
backpressure otherwise, with the admission window shrinking as the
session's staleness approaches the :class:`~repro_torch.core.streaming.
StalenessPolicy` thresholds; and every update is appended to a
:class:`~repro_torch.serve.wal.WriteAheadLog` *before* it is applied, so a
crash recovers by replay (:meth:`~repro_torch.core.api.Session.
restore_from_wal`).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Union

import numpy as np

from repro_torch import obs as _obs
from repro_torch.core.api import QuerySpec, Session, record_recompiles
from repro_torch.obs.slo import SLOTracker
from repro_torch.serve.flight import FlightRecorder


class LoadShedError(RuntimeError):
    """The request was rejected (or evicted) by admission control."""


# ---------------------------------------------------------------------- #
#  Request classes
# ---------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class RequestClass:
    """Latency/priority contract of a request.

    ``max_delay_ms`` is the continuous-batching deadline: a pending
    request is launched no later than this after submit, even in a
    partially filled bucket.  ``priority`` orders load shedding (lower
    sheds first).  ``sheddable`` marks requests admission control may
    reject under overload; point reads are *never* shed regardless (they
    are O(1) cache hits in steady state — shedding them buys nothing).
    """

    name: str
    max_delay_ms: float = 5.0
    priority: int = 10
    sheddable: bool = True


DEFAULT_REQUEST_CLASSES = {
    "point": RequestClass("point", max_delay_ms=2.0, priority=100,
                          sheddable=False),
    "interactive": RequestClass("interactive", max_delay_ms=5.0, priority=10),
    "batch": RequestClass("batch", max_delay_ms=50.0, priority=0),
}


# ---------------------------------------------------------------------- #
#  Tickets
# ---------------------------------------------------------------------- #
@dataclasses.dataclass
class Ticket:
    """One submitted request, completed (or failed) by the flush that
    serves it — a future.

    ``result`` is a scalar for point reads ([n] vector for full-graph
    reads); ``version`` is the snapshot version the answer was computed at
    (the pinned read version — not necessarily the write head).  A flush
    that raises mid-launch records the exception on ``error`` for exactly
    the affected tickets; :meth:`get` re-raises it in the submitter.
    """

    rid: int
    spec_index: int
    vertex: Optional[int]
    values: Optional[np.ndarray]
    submitted_s: float
    result: Optional[object] = None
    version: Optional[int] = None
    cache_hit: bool = False
    latency_s: float = 0.0
    error: Optional[BaseException] = None
    request_class: Optional[RequestClass] = None
    deadline_s: Optional[float] = None
    _event: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False, compare=False)
    _span: Optional[object] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def class_name(self) -> str:
        return self.request_class.name if self.request_class else "default"

    @property
    def done(self) -> bool:
        return self._event.is_set()

    @property
    def failed(self) -> bool:
        return self.error is not None

    @property
    def priority(self) -> int:
        return self.request_class.priority if self.request_class else 10

    def _finish(self) -> None:
        self._event.set()

    def get(self, timeout: Optional[float] = None):
        """Block until served; return the result or re-raise the recorded
        error (``LoadShedError`` if admission control evicted it)."""
        if not self._event.wait(timeout):
            raise TimeoutError(f"ticket {self.rid} not served "
                               f"within {timeout}s")
        if self.error is not None:
            raise self.error
        return self.result


# ---------------------------------------------------------------------- #
#  Affected-owner result cache
# ---------------------------------------------------------------------- #
class AffectedOwnerCache:
    """Vertex-level result cache invalidated by affected-owner sets.

    One entry per compiled plan group: the fused query's full result
    vectors (``{agg: [n]}``) plus a per-vertex validity mask.
    :meth:`on_update` clears ONLY the affected owners' bits — their
    windows are the only ones whose membership changed, so every other
    cached aggregate is still exact; groups without incremental state
    (no index to bound the blast radius) are dropped wholesale.

    Reads and writes are version-gated: entries are valid at
    :attr:`version` (advanced by ``on_update``), and a reader or writer
    pinned at any other version bypasses the cache instead of polluting
    it — that is what lets the serving layer keep reads pinned behind the
    write head (``auto_flip=False``) without ever serving stale hits.

    One lock makes each read, write and invalidation atomic: a
    ``put_group`` builds its entry first and then checks the version and
    stores it under the lock, so an invalidation can never land between a
    writer's version check and its store (where it would be lost, leaving
    a stale vector valid at the new version).
    """

    def __init__(self, obs=None):
        self._lock = threading.Lock()
        self.version = 0
        self._entries: Dict[int, Dict] = {}
        self.hits = 0
        self.misses = 0
        self.invalidated = 0  # per-vertex invalidations applied
        self.full_drops = 0  # whole entries dropped (stateless groups)
        obs = obs if obs is not None else _obs.get_registry()
        self._m_events = obs.counter(
            "repro_cache_events_total",
            "AffectedOwnerCache group-read/invalidation events",
            labels=("event",))

    def bind(self, session) -> None:
        """Called by :meth:`Session.attach_cache`."""
        self.version = session.version

    # ------------------------------- reads ---------------------------- #
    def get_group(self, gi: int, version: int):
        """Full vectors of group ``gi`` if entirely valid at ``version``."""
        with self._lock:
            e = self._entries.get(gi)
            if version != self.version or e is None or not e["valid_all"]:
                self.misses += 1
                self._m_events.labels("miss").inc()
                return None
            self.hits += 1
            self._m_events.labels("hit").inc()
            return {a: v.copy() for a, v in e["vectors"].items()}

    def get_point(self, gi: int, agg: str, vertex: int, version: int):
        """Cached aggregate of one vertex, or None on miss/stale.

        Not counted in :attr:`hits`/:attr:`misses` — those track
        full-vector group reads (refresh dedup); a point miss always falls
        through to a group read, so counting both would double-book it.
        The service keeps its own point-level counters.
        """
        with self._lock:
            e = self._entries.get(gi)
            if version != self.version or e is None or not e["valid"][vertex]:
                return None
            return e["vectors"][agg][vertex]

    # ------------------------------- writes --------------------------- #
    def put_group(self, gi: int, version: int, vectors: Dict) -> None:
        if version != self.version:
            return  # writer pinned behind the head: do not pollute
        vecs = {a: np.array(v) for a, v in vectors.items()}
        n = len(next(iter(vecs.values())))
        entry = {"vectors": vecs, "valid": np.ones(n, dtype=bool), "valid_all": True}
        with self._lock:
            if version == self.version:  # not overtaken while building
                self._entries[gi] = entry

    def on_update(self, version: int, owner_map: Dict) -> None:
        """Advance to ``version``.  ``owner_map[gi]`` is the group's
        affected-owner array, or None when the group has no incremental
        state (nothing bounds its staleness — drop the entry).

        The version advances *first*: a concurrent reader that computed a
        group vector at the old version must find its ``put_group``
        rejected by the gate rather than landing between the invalidation
        sweep and the bump (which would resurrect a stale vector at the
        new version — the lost-invalidation race).  No reader can be
        pinned *at* the new version yet: the serving layer flips only
        after this returns.
        """
        with self._lock:
            self.version = version
            for gi, owners in owner_map.items():
                e = self._entries.get(gi)
                if e is None:
                    continue
                if owners is None:
                    del self._entries[gi]
                    self.full_drops += 1
                    self._m_events.labels("drop").inc()
                    continue
                owners = np.asarray(owners, np.int64)
                e["valid"][owners] = False
                e["valid_all"] = bool(e["valid"].all())
                self.invalidated += int(owners.size)
                self._m_events.labels("invalidate").inc(int(owners.size))

    # ------------------------------------------------------------------ #
    def valid_fraction(self, gi: int) -> float:
        with self._lock:
            e = self._entries.get(gi)
            return float(e["valid"].mean()) if e is not None else 0.0

    @property
    def stats(self) -> Dict:
        total = self.hits + self.misses
        return {
            "version": self.version,
            "entries": len(self._entries),
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hits / max(total, 1),
            "invalidated": self.invalidated,
            "full_drops": self.full_drops,
        }


# ---------------------------------------------------------------------- #
#  WindowService
# ---------------------------------------------------------------------- #
class WindowService:
    """Micro-batched, versioned, cached front end over a Session.

    ``bucket`` fixes the padded batch size of coalesced explicit-values
    launches (one plan shape signature per group); ``auto_flip`` publishes every
    update to readers immediately (turn it off to pin readers at a version
    while a burst of updates lands, then :meth:`flip` once).

    Request model: :meth:`submit` enqueues and returns a :class:`Ticket`;
    :meth:`flush` serves everything pending against the active snapshot;
    :meth:`query` is submit+flush for one-call convenience.  A request
    names a compiled spec (index or the ``QuerySpec`` itself), optionally a
    ``vertex`` (point read) and optionally an explicit ``values`` vector
    (evaluate the spec's window under substitute attribute values — the
    classic serving pattern where each caller brings its own features).

    Flushes are exception-safe: a fused launch that raises fails exactly
    the tickets it was serving (error recorded on each
    :class:`Ticket`), the queue is already detached so nothing is
    stranded, the version-gated cache never holds partial results, and
    the next flush starts clean.
    """

    def __init__(self, session: Session, bucket: int = 8,
                 auto_flip: bool = True, use_cache: bool = True,
                 obs=None, tracer=None, now_fn=None,
                 flight_capacity: int = 256):
        self.session = session
        self.bucket = int(bucket)
        assert self.bucket >= 1
        self.auto_flip = auto_flip
        self.obs = obs if obs is not None else _obs.get_registry()
        self.tracer = tracer if tracer is not None else _obs.get_tracer()
        self.now = now_fn if now_fn is not None else time.perf_counter
        self.cache = AffectedOwnerCache(obs=self.obs) if use_cache else None
        if self.cache is not None:
            session.attach_cache(self.cache)
        self._active = session.snapshot()
        self._pending: List[Ticket] = []
        self._lock = threading.RLock()  # guards _pending + _rid
        self._flush_lock = threading.Lock()  # serializes _serve bodies
        self._rid = 0
        self._spec_index = {s: i for i, s in enumerate(session.compiled.specs)}
        # telemetry (attribute counters stay; obs mirrors them with labels)
        self.flushes = 0
        self.batched_launches = 0
        self.padded_rows = 0
        self.served = 0
        self.failed = 0
        self.point_hits = 0
        self.point_misses = 0
        self.slo = SLOTracker(self.obs)
        # flight recorder: always on (a crash artifact must exist for
        # crashes that never scheduled an instrumented run); one dict +
        # deque append per event keeps it inside the <5% obs budget
        self.flight = FlightRecorder(capacity=flight_capacity)
        #: events captured at the moment a ticket last failed (the
        #: automatic dump; None until a failure happens)
        self.last_flight_record: Optional[List[Dict]] = None
        #: shadow auditor sampling served tickets (None = auditing off);
        #: see :meth:`attach_auditor`
        self.auditor = None
        self._m_flushes = self.obs.counter(
            "repro_flushes_total", "queue flushes by trigger",
            labels=("reason",))
        self._m_launches = self.obs.counter(
            "repro_batched_launches_total",
            "padded run_many device launches")
        self._m_padded = self.obs.counter(
            "repro_padded_rows_total", "pad rows in batched launches")
        self._m_point = self.obs.counter(
            "repro_point_reads_total", "point reads through the result cache",
            labels=("event",))
        self._m_flush_size = self.obs.histogram(
            "repro_flush_size_records", "tickets served per flush",
            buckets=_obs.DEFAULT_SIZE_BUCKETS)
        self._m_updates = self.obs.counter(
            "repro_service_updates_total", "update batches streamed in")
        self._m_flips = self.obs.counter(
            "repro_flips_total", "snapshot publishes to readers")

    # ------------------------------------------------------------------ #
    @property
    def version(self) -> int:
        """The pinned read version (what queries answer at)."""
        return self._active.version

    @property
    def head_version(self) -> int:
        """The write head (latest applied update)."""
        return self.session.version

    # ------------------------------------------------------------------ #
    def _resolve(self, spec) -> int:
        if isinstance(spec, (int, np.integer)):
            if not 0 <= int(spec) < len(self.session.compiled.specs):
                raise IndexError(f"spec index {spec} out of range")
            return int(spec)
        if not isinstance(spec, QuerySpec):
            raise TypeError(f"spec must be an int index or QuerySpec, "
                            f"got {spec!r}")
        if spec not in self._spec_index:
            raise KeyError(
                f"{spec} is not compiled into this session; compiled specs: "
                f"{list(self.session.compiled.specs)}"
            )
        return self._spec_index[spec]

    def _make_ticket(self, spec, vertex: Optional[int], values,
                     request_class: Optional[RequestClass] = None) -> Ticket:
        """Validate and build (but do not enqueue) one request.

        Everything is validated here, not at flush time — one malformed
        request must fail its own submit, never poison a whole coalesced
        flush of other callers' tickets."""
        si = self._resolve(spec)
        n = self.session.graph.n
        if vertex is not None:
            vertex = int(vertex)
            if not 0 <= vertex < n:
                raise IndexError(f"vertex {vertex} out of range [0, {n})")
        if values is not None:
            # f32 conversion here: a non-numeric vector must fail its own
            # submit, not blow up mid-flush (the executors cast to f32
            # anyway, so results are unchanged).  np.array (not asarray)
            # so a caller reusing one scratch buffer between submit and
            # flush cannot mutate an already-queued request.
            values = np.array(values, np.float32)
            if values.shape != (n,):
                raise ValueError(
                    f"per-request values must have shape ({n},), "
                    f"got {values.shape}"
                )
        now = self.now()
        deadline = (now + self._delay_s(request_class)
                    if request_class is not None else None)
        with self._lock:
            rid = self._rid
            self._rid += 1
        t = Ticket(
            rid=rid, spec_index=si, vertex=vertex, values=values,
            submitted_s=now, request_class=request_class,
            deadline_s=deadline,
        )
        # detached span: the ticket lifecycle crosses threads (submitted
        # here, finished by whichever flush serves it)
        t._span = self.tracer.start_span(
            "request", cat="ticket", rid=rid,
            cls=t.class_name, point=vertex is not None)
        self.flight.record("admit", rid=rid, cls=t.class_name,
                           point=vertex is not None,
                           version=self._active.version)
        return t

    def _delay_s(self, request_class: RequestClass) -> float:
        """Scheduling delay for one class, in seconds.  The base service
        uses the declared ``max_delay_ms``; the async tier may run a
        tighter *effective* delay under SLO-controller pressure (never a
        looser one — the declared deadline is a hard bound)."""
        return request_class.max_delay_ms / 1e3

    def attach_auditor(self, auditor) -> "WindowService":
        """Attach a :class:`~repro_torch.obs.audit.ShadowAuditor`: every flush
        offers its served tickets for sampling (the auditor re-evaluates
        asynchronously; a full audit queue drops samples, never blocking
        serving).  Call ``auditor.start()`` separately."""
        self.auditor = auditor
        auditor.bind(self)
        return self

    def submit(self, spec, vertex: Optional[int] = None,
               values=None) -> Ticket:
        """Enqueue one request; returns its (unfilled) :class:`Ticket`."""
        t = self._make_ticket(spec, vertex, values)
        with self._lock:
            self._pending.append(t)
        return t

    def query(self, spec, vertex: Optional[int] = None, values=None):
        """Submit + flush; returns the result directly (raises the
        recorded error if the serving launch failed)."""
        t = self.submit(spec, vertex=vertex, values=values)
        self.flush()
        return t.get(timeout=0)

    # ------------------------------------------------------------------ #
    def _serve_snapshot(self, view, gi: int, agg: str,
                        vertex: Optional[int], memo: Dict):
        """Current-attribute read through the affected-owner cache.

        ``memo`` holds group vectors already computed *this flush*: when
        the versioned cache cannot serve (``use_cache=False``, or a reader
        pinned behind the write head bypassing it), N point reads of one
        group still cost one fused launch, not N.  A failed group launch
        poisons the memo slot with its exception, so later tickets of the
        same group fail fast instead of re-raising from a fresh launch.
        """
        if self.cache is not None and vertex is not None:
            hit = self.cache.get_point(gi, agg, vertex, view.version)
            if hit is not None:
                self.point_hits += 1
                self._m_point.labels("hit").inc()
                return hit, True
            self.point_misses += 1
            self._m_point.labels("miss").inc()
        # miss (or full read): one fused launch refreshes the whole group
        # vector — in the cache (cache-aware run_group) and the flush memo
        out = memo.get(gi)
        if isinstance(out, BaseException):
            raise out
        if out is None:
            try:
                out = memo[gi] = view.run_group(gi)
            except BaseException as e:
                memo[gi] = e
                raise
        vec = out[agg]
        # full reads copy at the ticket boundary: several tickets may share
        # one memo/cache vector, and a caller mutating its result must not
        # corrupt another caller's answer
        return (vec[vertex] if vertex is not None else vec.copy()), False

    def _take_pending(self) -> List[Ticket]:
        """Atomically detach the queue (so a raise can never strand it)."""
        with self._lock:
            pending, self._pending = self._pending, []
        return pending

    def flush(self, reason: str = "manual") -> List[Ticket]:
        """Serve every pending request against the active snapshot.

        Current-state requests (``values=None``) ride the affected-owner
        cache — point reads are O(1) hits in steady state.  Explicit-values
        requests coalesce per plan group into ``ceil(B / bucket)`` padded
        ``run_group_many`` calls, so requests for *different* aggregates of
        one (window, attr) group share a call (they are channels of the
        same fused plan) and the [bucket, n] shape never moves.

        ``reason`` labels the flush trigger in the metrics: "manual" here,
        "fill"/"deadline" when the continuous-batching front end decides.
        """
        with self._flush_lock:
            return self._serve(self._take_pending(), reason)

    def _serve(self, pending: List[Ticket],
               reason: str = "manual") -> List[Ticket]:
        if not pending:
            return pending
        with self.tracer.span("flush", cat="serve", reason=reason,
                              pending=len(pending)):
            return self._serve_inner(pending, reason)

    def _serve_inner(self, pending: List[Ticket],
                     reason: str) -> List[Ticket]:
        view = self._active
        groups = self.session.compiled.groups
        slots = self.session.compiled.spec_slots
        by_group: Dict[int, List[Ticket]] = {}
        memo: Dict[int, object] = {}  # group vectors (or poison) this flush
        for t in pending:
            gi, ai = slots[t.spec_index]
            if t.values is None:
                try:
                    t.result, t.cache_hit = self._serve_snapshot(
                        view, gi, groups[gi].aggs[ai], t.vertex, memo
                    )
                    t.version = view.version
                except BaseException as e:
                    t.error = e
            else:
                by_group.setdefault(gi, []).append(t)
        n = view.graph.n
        for gi, reqs in by_group.items():
            grp = groups[gi]
            # padding buys one fixed shape only on the fused device paths;
            # a host group would pay one full sequential query per pad row
            # for nothing.  artifacts[gi] holds one
            # (index, plan) pair per materialized term (composite windows
            # on the algebraic fast path carry several).
            pad = (
                self.session.registry.capability(grp.engine).device
                and any(p is not None for _, p in view.artifacts[gi])
            )
            for lo in range(0, len(reqs), self.bucket):
                chunk = reqs[lo: lo + self.bucket]
                rows_n = self.bucket if pad else len(chunk)
                vb = np.zeros((rows_n, n), np.float32)  # fixed bucket
                for row, t in enumerate(chunk):
                    vb[row] = t.values
                try:
                    with self.tracer.span("launch", cat="serve", group=gi,
                                          rows=rows_n, filled=len(chunk)):
                        out = view.run_group_many(gi, vb)
                except BaseException as e:
                    # fail exactly this chunk's tickets; other chunks (and
                    # other groups) still get served, and the queue was
                    # detached up front so the next flush starts clean
                    for t in chunk:
                        t.error = e
                    continue
                self.batched_launches += 1
                self.padded_rows += rows_n - len(chunk)
                self._m_launches.inc()
                self._m_padded.inc(rows_n - len(chunk))
                for row, t in enumerate(chunk):
                    _, ai = slots[t.spec_index]
                    vec = out[grp.aggs[ai]][row]
                    t.result = (vec[t.vertex] if t.vertex is not None
                                else np.asarray(vec))
                    t.version = view.version
        now = self.now()
        ok = 0
        for t in pending:
            t.latency_s = now - t.submitted_s
            if t.error is None:
                ok += 1
            target = (t.request_class.max_delay_ms / 1e3
                      if t.request_class is not None else None)
            self.slo.observe(
                t.class_name, t.latency_s, target,
                "ok" if t.error is None else "error")
            if t._span is not None:
                t._span.set(version=t.version, cache_hit=t.cache_hit,
                            ok=t.error is None).finish()
            t._finish()
        self.flushes += 1
        self.served += ok
        self.failed += len(pending) - ok
        self._m_flushes.labels(reason).inc()
        self._m_flush_size.observe(len(pending))
        self.flight.record("flush", reason=reason, tickets=len(pending),
                           served=ok, failed=len(pending) - ok,
                           version=view.version)
        if self.auditor is not None:
            try:
                self.auditor.observe_flush(view, pending)
            except Exception:
                pass  # auditing is evidence, never a serving failure
        if ok < len(pending):
            self._on_ticket_failure([t for t in pending
                                     if t.error is not None])
        return pending

    # ------------------------------------------------------------------ #
    def _on_ticket_failure(self, failed: List[Ticket]) -> None:
        """A ticket finished with an error: stamp failure events and dump
        the flight record automatically — the recent admit/shed/flush/
        patch/flip history IS the crash context."""
        for t in failed:
            self.flight.record(
                "failure", rid=t.rid, cls=t.class_name,
                error=type(t.error).__name__, detail=str(t.error)[:200])
        self.last_flight_record = self.flight.dump()

    def debug_report(self) -> Dict:
        """One structured dump of everything the service knows about
        itself: counters, serving-bucket padding waste, cache/SLO stats,
        staleness ratios, device-plan footprint, and the flight-recorder
        ring — the ANALYZE companion for the serving tier."""
        launched_rows = self.batched_launches * self.bucket
        report = {
            "stats": self.stats,
            "padding": {
                "bucket": self.bucket,
                "batched_launches": self.batched_launches,
                "padded_rows": self.padded_rows,
                "waste_fraction": (self.padded_rows / launched_rows
                                   if launched_rows else 0.0),
            },
            "staleness": self.session.staleness,
            "plan_footprint_bytes": int(
                self.session.explain().total_plan_nbytes),
            "flight": {
                "capacity": self.flight.capacity,
                "dropped": self.flight.dropped,
                "events": self.flight.dump(),
            },
            "last_flight_record": self.last_flight_record,
        }
        if self.auditor is not None:
            report["audit"] = self.auditor.stats
        return report

    # ------------------------------------------------------------------ #
    def update(self, batch) -> Dict:
        """Stream one UpdateBatch into the write head.

        Readers keep the active snapshot until :meth:`flip` (automatic
        when ``auto_flip``).  The session invalidates the attached cache
        for exactly the batch's affected-owner sets; version gating means
        a reader still pinned behind the head simply bypasses the cache
        rather than ever seeing version-v+1 data at version v.
        """
        with self.tracer.span("service.update", cat="update"):
            reports = self.session.update(batch)
            for key, rep in reports.items():
                self.flight.record(
                    "patch", key=key,
                    version=rep.get("version"),
                    plan_version=rep.get("plan_version"),
                    affected=int(np.size(rep.get("affected_owners", ()))),
                    reorganized=bool(rep.get("reorganized", False)))
            if self.auto_flip:
                self.flip()
        self._m_updates.inc()
        return reports

    def flip(self) -> int:
        """Atomically publish the newest version to readers: one reference
        swap of an immutable snapshot (no reader ever holds a half-patched
        plan — it holds either the old view or the new one)."""
        self._active = self.session.snapshot()
        self._m_flips.inc()
        self.flight.record("flip", version=self._active.version)
        return self._active.version

    # ------------------------------------------------------------------ #
    @property
    def stats(self) -> Dict:
        point = self.point_hits + self.point_misses
        out = {
            "served": self.served,
            "failed": self.failed,
            "flushes": self.flushes,
            "batched_launches": self.batched_launches,
            "padded_rows": self.padded_rows,
            "bucket": self.bucket,
            "active_version": self._active.version,
            "head_version": self.session.version,
            "point_hits": self.point_hits,
            "point_misses": self.point_misses,
            "point_hit_rate": self.point_hits / max(point, 1),
        }
        if self.cache is not None:
            out["cache"] = self.cache.stats
        out["recompiles"] = record_recompiles(self.obs)
        if self.obs.enabled:
            out["slo"] = self.slo.report()
        return out


# ---------------------------------------------------------------------- #
#  AsyncWindowService — continuous batching + durability
# ---------------------------------------------------------------------- #
class AsyncWindowService(WindowService):
    """Continuous-batching front end: deadline-driven background flusher,
    staleness-aware admission control, and WAL durability.

    * **Deadline-or-fill flushing** — a daemon flusher launches the
      pending queue when it holds a full ``bucket`` (fill flush) or when
      the earliest ticket's per-class deadline (``max_delay_ms``) expires
      (deadline flush).  At low load this bounds p99 latency by the
      deadline instead of by "whenever the bucket happens to fill".

    * **Backpressure + load shedding** — when the queue reaches the
      admission window, the lowest-priority *sheddable full-graph scan*
      is evicted first (its submitter sees :class:`LoadShedError`); point
      reads are never shed.  If the incoming request is itself the
      lowest-priority sheddable scan, *it* is rejected.  A non-sheddable
      request with nothing to evict waits (backpressure) for the flusher
      to drain.  The admission window shrinks as the session's staleness
      ratios approach the :class:`~repro_torch.core.streaming.StalenessPolicy`
      thresholds (:meth:`pressure`) — a stale index is about to pay a
      reorganize, so the service trims its queue before that stall.

    * **Write-ahead logging** — :meth:`update` appends the batch to the
      WAL *before* applying it (append-before-apply): any state a reader
      could ever have observed is reconstructible by
      :meth:`Session.restore_from_wal`.

    Use as a context manager (or :meth:`start`/:meth:`stop`).  Without
    ``start()`` the service degrades to the synchronous base behavior
    (submit + explicit :meth:`flush`), deadlines unenforced.
    """

    def __init__(self, session: Session, bucket: int = 8,
                 auto_flip: bool = True, use_cache: bool = True,
                 classes: Optional[Dict[str, RequestClass]] = None,
                 default_class: str = "interactive",
                 max_pending: int = 256,
                 wal: Union[None, str, "object"] = None,
                 wal_digests: bool = True, digest_results: bool = False,
                 policy=None, obs=None, tracer=None, now_fn=None):
        super().__init__(session, bucket=bucket, auto_flip=auto_flip,
                         use_cache=use_cache, obs=obs, tracer=tracer,
                         now_fn=now_fn)
        #: stamp a per-version content digest into the WAL after every
        #: update (a follower's self-check channel); ``digest_results``
        #: additionally folds the served result vectors in
        self.wal_digests = bool(wal_digests)
        self.digest_results = bool(digest_results)
        self.classes = dict(DEFAULT_REQUEST_CLASSES)
        if classes:
            self.classes.update(classes)
        self.default_class = default_class
        self.max_pending = int(max_pending)
        assert self.max_pending >= self.bucket
        #: SLO-controller overrides: per-class *effective* scheduling delay
        #: in ms, clamped to ``(0, declared max_delay_ms]`` at use time
        self.class_delay_ms: Dict[str, float] = {}
        #: fill trigger (queue depth that launches immediately) in
        #: ``[1, bucket]`` — the controller trades launch occupancy for
        #: latency; the compiled ``[bucket, n]`` executor shape never moves
        self.fill_threshold = self.bucket
        if wal is not None and not hasattr(wal, "append"):
            from repro_torch.serve.wal import WriteAheadLog

            wal = WriteAheadLog(wal, obs=self.obs)
        self.wal = wal
        if policy is None:
            from repro_torch.core.streaming import StalenessPolicy

            policy = StalenessPolicy()
        self.policy = policy
        self._cv = threading.Condition(self._lock)
        self._update_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stopping = False
        self._drain = True
        # telemetry
        self.shed = 0
        self.deadline_flushes = 0
        self.fill_flushes = 0
        self.backpressure_waits = 0
        self._m_shed = self.obs.counter(
            "repro_shed_total", "tickets rejected/evicted by admission")
        self._m_backpressure = self.obs.counter(
            "repro_backpressure_waits_total",
            "submit waits for the flusher to drain")
        self._g_pressure = self.obs.gauge(
            "repro_service_pressure", "staleness pressure in [0, 1]")
        self._g_pending = self.obs.gauge(
            "repro_pending_requests", "queue depth after last submit/flush")

    # --------------------------- lifecycle ---------------------------- #
    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "AsyncWindowService":
        if self.running:
            return self
        self._stopping = False
        self._thread = threading.Thread(target=self._flusher_loop,
                                        name="window-service-flusher",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, drain: bool = True) -> None:
        """Stop the flusher; ``drain=True`` serves everything still
        pending first (``False`` fails the leftovers with
        :class:`LoadShedError`)."""
        if self._thread is None:
            return
        with self._cv:
            self._stopping = True
            self._drain = drain
            self._cv.notify_all()
        self._thread.join(timeout=30)
        self._thread = None
        if drain:
            self.flush()
        else:
            for t in self._take_pending():
                t.error = LoadShedError("service stopped without drain")
                self._drop_ticket(t)
                self.failed += 1
        if self.wal is not None:
            self.wal.sync()

    def __enter__(self) -> "AsyncWindowService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop(drain=True)

    def close(self) -> None:
        self.stop(drain=True)
        if self.wal is not None:
            self.wal.close()

    # --------------------------- admission ---------------------------- #
    def pressure(self) -> float:
        """Staleness pressure in [0, 1]: 0 = freshly reorganized, 1 = at
        the policy's reorganize thresholds.  The growth ratios start at
        1.0 (a fresh index *is* its own baseline), so they are normalized
        over the remaining headroom to the threshold."""
        pol = self.policy
        p = 0.0
        for s in self.session.staleness.values():
            p = max(
                p,
                (s["link_ratio"] - 1.0) / max(pol.max_link_ratio - 1.0, 1e-9),
                (s["block_ratio"] - 1.0)
                / max(pol.max_block_ratio - 1.0, 1e-9),
                s["garbage_ratio"] / max(pol.max_garbage_ratio, 1e-9),
            )
        p = float(min(max(p, 0.0), 1.0))
        self._g_pressure.set(p)
        return p

    def effective_max_pending(self) -> int:
        """Admission window: ``max_pending`` scaled down by staleness
        pressure (down to one bucket at full pressure)."""
        lo = self.bucket
        span = self.max_pending - lo
        return int(lo + span * (1.0 - self.pressure()))

    def _pick_victim(self, incoming: Ticket) -> Optional[Ticket]:
        """Lowest-priority sheddable full-graph scan among pending +
        incoming (ties: newest first, preserving FIFO among equals).
        Returns None when nothing is sheddable (point reads never are)."""
        candidates = [
            t for t in self._pending
            if t.vertex is None and t.request_class is not None
            and t.request_class.sheddable
        ]
        if (incoming.vertex is None and incoming.request_class is not None
                and incoming.request_class.sheddable):
            candidates.append(incoming)
        if not candidates:
            return None
        return min(candidates, key=lambda t: (t.priority, -t.rid))

    def _drop_ticket(self, t: Ticket) -> None:
        """Account one admission-control casualty (``t.error`` already
        holds the :class:`LoadShedError`) and release its waiter."""
        self._m_shed.inc()
        self.flight.record("shed", rid=t.rid, cls=t.class_name,
                           reason=str(t.error)[:200],
                           version=self._active.version)
        self.slo.observe(
            t.class_name, self.now() - t.submitted_s,
            (t.request_class.max_delay_ms / 1e3
             if t.request_class is not None else None),
            "shed")
        if t._span is not None:
            t._span.set(ok=False, shed=True).finish()
        t._finish()

    def submit(self, spec, vertex: Optional[int] = None, values=None,
               request_class: Union[None, str, RequestClass] = None
               ) -> Ticket:
        """Enqueue with admission control; wakes the flusher.

        Raises :class:`LoadShedError` if the request itself is shed at
        admission.  An evicted *pending* ticket gets the error recorded
        and its waiter released instead."""
        if request_class is None:
            request_class = ("point" if vertex is not None
                             else self.default_class)
        if isinstance(request_class, str):
            request_class = self.classes[request_class]
        t = self._make_ticket(spec, vertex, values, request_class)
        with self._cv:
            while len(self._pending) >= self.effective_max_pending():
                victim = self._pick_victim(t)
                if victim is t:
                    self.shed += 1
                    self.failed += 1
                    t.error = LoadShedError(
                        f"request shed at admission (queue "
                        f"{len(self._pending)}, pressure {self.pressure():.2f})"
                    )
                    self._drop_ticket(t)
                    raise t.error
                if victim is not None:
                    self._pending.remove(victim)
                    victim.error = LoadShedError(
                        "evicted by a higher-priority request under overload"
                    )
                    self._drop_ticket(victim)
                    self.shed += 1
                    self.failed += 1
                    continue
                # nothing sheddable (all point reads): backpressure —
                # wait for the flusher to drain.  Without a running
                # flusher nobody will drain for us: serve synchronously.
                if not self.running:
                    break
                self.backpressure_waits += 1
                self._m_backpressure.inc()
                self._cv.wait(timeout=0.01)
            self._pending.append(t)
            self._g_pending.set(len(self._pending))
            self._cv.notify_all()
        if not self.running:
            # no flusher thread: enforce fill/deadline synchronously so
            # the scheduling contract (and its counters) hold either way
            self.flush_if_due()
        return t

    # --------------------------- flushing ----------------------------- #
    def _delay_s(self, request_class: RequestClass) -> float:
        declared = request_class.max_delay_ms
        eff = self.class_delay_ms.get(request_class.name, declared)
        # the declared deadline is a ceiling, never raised; floor keeps a
        # runaway controller from busy-flushing every submit
        return min(max(eff, 0.05), declared) / 1e3

    def flush(self, reason: str = "manual") -> List[Ticket]:
        served = super().flush(reason)
        with self._cv:
            self._g_pending.set(len(self._pending))
            self._cv.notify_all()  # release backpressure waiters
        return served

    def _due_reason(self):
        """Why the queue should launch NOW — ``("fill" | "deadline", dl)``
        — or ``(None, dl)`` with the earliest deadline to sleep toward
        (``dl`` None when the queue is empty).  Caller holds the lock.

        This is the single scheduling decision, shared by the background
        flusher and the synchronous :meth:`flush_if_due` path, and it runs
        on the injected clock — tests drive it deterministically with a
        fake ``now_fn``.
        """
        if not self._pending:
            return None, None
        if len(self._pending) >= max(1, min(self.fill_threshold,
                                            self.bucket)):
            return "fill", None
        now = self.now()
        dl = min(t.deadline_s if t.deadline_s is not None else now + 0.05
                 for t in self._pending)
        if now >= dl:
            return "deadline", dl
        return None, dl

    def flush_if_due(self) -> List[Ticket]:
        """Synchronously flush iff the scheduling contract says so
        (bucket full, or the earliest deadline has passed on the injected
        clock).  Returns the served tickets ([] when not due)."""
        with self._cv:
            reason, _ = self._due_reason()
        if reason is None:
            return []
        return self._flush_reason(reason)

    def _flush_reason(self, reason: str) -> List[Ticket]:
        if reason == "fill":
            self.fill_flushes += 1
        else:
            self.deadline_flushes += 1
        return self.flush(reason)

    def _flusher_loop(self) -> None:
        self.tracer.name_thread()
        while True:
            reason = None
            with self._cv:
                while reason is None:
                    if self._stopping:
                        return  # stop() drains (or fails) the leftovers
                    reason, dl = self._due_reason()
                    if reason is not None:
                        break
                    if dl is None:
                        self._cv.wait(timeout=0.05)
                        continue
                    self._cv.wait(timeout=max(dl - self.now(), 1e-4))
            try:
                self._flush_reason(reason)
            except Exception:
                # _serve records per-ticket errors; anything escaping here
                # is a bug in the scheduler itself — keep the loop alive,
                # the queue was detached so no ticket is stranded
                pass

    # --------------------------- durability --------------------------- #
    def update(self, batch) -> Dict:
        """Append-before-apply: the batch is durable in the WAL before any
        reader can observe its effects, so replaying the log into a fresh
        session always reproduces (a prefix of) the served states."""
        with self._update_lock:
            if self.wal is not None:
                with self.tracer.span("wal.append", cat="update",
                                      version=self.session.version + 1):
                    self.wal.append(batch, version=self.session.version + 1)
                self.flight.record("wal_commit",
                                   version=self.session.version + 1,
                                   records=int(getattr(batch, "size", 0)))
            reports = super().update(batch)
            if self.wal is not None and self.wal_digests \
                    and hasattr(self.wal, "append_digest"):
                # the leader's per-version content attestation: written
                # after apply (the digest covers the *produced* state) but
                # still under the update lock, so record/digest pairs stay
                # adjacent and in version order in the log
                self.wal.append_digest(
                    self.session.digest(
                        include_results=self.digest_results),
                    version=self.session.version)
            return reports

    # ------------------------------------------------------------------ #
    @property
    def stats(self) -> Dict:
        out = super().stats
        out.update(
            shed=self.shed,
            deadline_flushes=self.deadline_flushes,
            fill_flushes=self.fill_flushes,
            backpressure_waits=self.backpressure_waits,
            pending=len(self._pending),
            max_pending=self.max_pending,
            effective_max_pending=self.effective_max_pending(),
            pressure=self.pressure(),
            running=self.running,
        )
        out["class_delay_ms"] = dict(self.class_delay_ms)
        out["fill_threshold"] = self.fill_threshold
        if self.wal is not None:
            out["wal"] = self.wal.stats
        return out


# ---------------------------------------------------------------------- #
#  SLOController: close the measure → adapt loop
# ---------------------------------------------------------------------- #
class SLOController:
    """Adapt an :class:`AsyncWindowService`'s batching knobs from measured
    per-class SLO attainment, within declared bounds.

    Two knobs, both shape-safe (the ``[bucket, n]`` batch never moves):

    * **per-class effective delay** (``service.class_delay_ms``) — how
      long the scheduler may hold a ticket for batching.  Tightening it
      flushes earlier, trading launch occupancy for latency.  Hard bounds:
      never above the class's *declared* ``max_delay_ms`` (the deadline
      contract is inviolable), never below ``min_delay_ms``.
    * **fill threshold** (``service.fill_threshold``) — the queue depth
      that triggers an immediate launch, in ``[1, bucket]``.  Lowered when
      the worst class is missing (smaller, sooner launches), restored
      toward ``bucket`` when every class is comfortably attaining.

    Decisions are **windowed and hysteretic**: each :meth:`step` scores
    the attainment of tickets finished *since the previous step* (deltas
    of :meth:`~repro_torch.obs.slo.SLOTracker.counts`, so one bad cold-start
    window can't haunt the cumulative ratio), ignores windows with fewer
    than ``min_samples`` ok tickets, and only acts after ``hysteresis``
    consecutive agreeing windows — a single noisy window never flips the
    knobs.  Steps are multiplicative (``tighten_factor`` down,
    ``relax_factor`` up) so convergence is geometric from either side.

    Every decision is exported:
    ``repro_slo_controller_decisions_total{cls, action}`` (actions
    ``tighten`` / ``relax`` / ``hold``) and gauges
    ``repro_slo_effective_delay_ms{cls}`` / ``repro_slo_fill_threshold``.
    Drive it manually (:meth:`step` after each serving window — tests use
    this, wall-clock-free) or with :meth:`start` on a background thread.

    Requires a live metrics registry: under a ``NullRegistry`` the
    tracker records nothing, every window is empty, and the controller
    holds (by design — no evidence, no movement).
    """

    def __init__(self, service: AsyncWindowService, *,
                 target_attainment: float = 0.95,
                 min_delay_ms: float = 0.25,
                 tighten_factor: float = 0.6,
                 relax_factor: float = 1.25,
                 hysteresis: int = 2,
                 min_samples: int = 16,
                 adapt_fill: bool = True,
                 obs=None):
        assert 0.0 < target_attainment <= 1.0
        assert 0.0 < tighten_factor < 1.0 < relax_factor
        self.service = service
        self.target_attainment = float(target_attainment)
        self.min_delay_ms = float(min_delay_ms)
        self.tighten_factor = float(tighten_factor)
        self.relax_factor = float(relax_factor)
        self.hysteresis = max(int(hysteresis), 1)
        self.min_samples = max(int(min_samples), 1)
        self.adapt_fill = bool(adapt_fill)
        self._obs_explicit = obs
        self._last_counts: Dict[str, Dict[str, float]] = {}
        self._miss_streak: Dict[str, int] = {}
        self._ok_streak: Dict[str, int] = {}
        self.steps = 0
        self.decisions: List[Dict] = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ------------------------------------------------------------------ #
    @property
    def obs(self):
        """Registry resolved at call time (the obs re-enable rule)."""
        return (self._obs_explicit if self._obs_explicit is not None
                else _obs.get_registry())

    def _record(self, cls: str, action: str, delay_ms: float) -> None:
        reg = self.obs
        reg.counter("repro_slo_controller_decisions_total",
                    "SLO controller decisions", labels=("cls", "action")
                    ).labels(cls, action).inc()
        reg.gauge("repro_slo_effective_delay_ms",
                  "controller-effective scheduling delay",
                  labels=("cls",)).labels(cls).set(delay_ms)
        self.decisions.append({"step": self.steps, "cls": cls,
                               "action": action, "delay_ms": delay_ms})

    def effective_delay_ms(self, cls: str) -> float:
        declared = self.service.classes[cls].max_delay_ms
        return min(self.service.class_delay_ms.get(cls, declared), declared)

    def step(self) -> Dict[str, str]:
        """Score the window since the last step; move the knobs.  Returns
        ``{cls: action}`` for every declared class."""
        svc = self.service
        self.steps += 1
        actions: Dict[str, str] = {}
        worst_missing = False
        for cls_name, rc in svc.classes.items():
            cur = svc.slo.counts(cls_name)
            prev = self._last_counts.get(cls_name,
                                         {k: 0.0 for k in cur})
            self._last_counts[cls_name] = cur
            d_ok = cur["ok"] - prev["ok"]
            d_within = cur["within"] - prev["within"]
            eff = self.effective_delay_ms(cls_name)
            if d_ok < self.min_samples:
                actions[cls_name] = "hold"
                self._record(cls_name, "hold", eff)
                continue
            attainment = d_within / d_ok
            if attainment < self.target_attainment:
                worst_missing = True
                self._miss_streak[cls_name] = \
                    self._miss_streak.get(cls_name, 0) + 1
                self._ok_streak[cls_name] = 0
                if self._miss_streak[cls_name] >= self.hysteresis \
                        and eff > self.min_delay_ms:
                    new = max(eff * self.tighten_factor, self.min_delay_ms)
                    svc.class_delay_ms[cls_name] = new
                    self._miss_streak[cls_name] = 0
                    actions[cls_name] = "tighten"
                    self._record(cls_name, "tighten", new)
                    continue
            else:
                self._ok_streak[cls_name] = \
                    self._ok_streak.get(cls_name, 0) + 1
                self._miss_streak[cls_name] = 0
                if self._ok_streak[cls_name] >= self.hysteresis \
                        and eff < rc.max_delay_ms:
                    new = min(eff * self.relax_factor, rc.max_delay_ms)
                    svc.class_delay_ms[cls_name] = new
                    self._ok_streak[cls_name] = 0
                    actions[cls_name] = "relax"
                    self._record(cls_name, "relax", new)
                    continue
            actions[cls_name] = "hold"
            self._record(cls_name, "hold", eff)
        if self.adapt_fill:
            if worst_missing:
                svc.fill_threshold = max(1, svc.fill_threshold - 1)
            elif all(a in ("hold", "relax") for a in actions.values()):
                svc.fill_threshold = min(svc.bucket, svc.fill_threshold + 1)
            self.obs.gauge("repro_slo_fill_threshold",
                           "controller-effective fill trigger depth"
                           ).set(svc.fill_threshold)
        return actions

    # --------------------------- background ---------------------------- #
    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self, interval_s: float = 0.25) -> "SLOController":
        """Step continuously on a daemon thread until :meth:`stop`."""
        if not self.running:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, args=(float(interval_s),),
                name="slo-controller", daemon=True)
            self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None

    def _loop(self, interval_s: float) -> None:
        while not self._stop.is_set():
            try:
                self.step()
            except Exception:
                pass  # a controller hiccup must never take serving down
            self._stop.wait(interval_s)

    @property
    def stats(self) -> Dict:
        return {
            "steps": self.steps,
            "running": self.running,
            "fill_threshold": self.service.fill_threshold,
            "class_delay_ms": {
                cls: self.effective_delay_ms(cls)
                for cls in self.service.classes},
            "decisions": self.decisions[-32:],
        }

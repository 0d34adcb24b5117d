"""Online correctness auditing: shadow oracle, content digests, WAL scrub.

The repo's correctness backbone — every engine bit-identical to the
set-evaluation oracle — is asserted by tests; this module *observes* it
in the running system through three independent evidence channels:

* :class:`ShadowAuditor` — samples a configurable fraction of served
  tickets (plus a trickle of rows from full-graph results), re-evaluates
  each sample **asynchronously** on a background thread against the
  independent per-vertex set-evaluation oracle (:func:`oracle_single`,
  the same math as ``repro_torch.core.query.brute_force`` restricted to one
  vertex) *at the pinned snapshot version* — MVCC makes the replay
  well-defined: the sample captures the immutable graph the view served
  from, so the oracle sees exactly what the engine saw.  Comparison is
  bitwise; a mismatch quarantines an :class:`AuditFinding`, increments
  ``repro_audit_mismatches_total`` and lands a flight-recorder event.

* **Digest channel** — :func:`session_digest` folds cheap crc32 content
  digests over the graph arrays, every plan tensor (each plan's
  ``named_arrays()``, the tensors its ``array_nbytes()`` counts, copied to
  the host) and optionally the full result vectors.  The leader stamps
  one digest into the WAL after every published version
  (:meth:`repro_torch.serve.wal.WriteAheadLog.append_digest`), so a
  follower self-checks after every poll and attributes divergence to the
  **first bad version + WAL byte offset**.  The graph and DBIndex plan
  digests equal the reference package's wherever the arrays are equal,
  and so does a sharded plan's (its whole canonical layout); the I-Index
  plan's covers the port's own arrays (the chain layout too).

* :class:`WalScrubber` — background sweep of the *sealed* log region
  (records wholly below the WAL's fsync high-water mark) re-verifying
  every record CRC independent of replay, so at-rest corruption ("CRC
  rot") is found proactively instead of at the next crash recovery.

Sampling never blocks serving: the auditor's queue is bounded and
``put_nowait`` drops (counted in ``repro_audit_dropped_total``) rather
than waiting, and capture is O(1) references to immutable snapshot state.

Bitwise comparison leans on the repo invariant that holds everywhere the
suite asserts it: integer-valued attributes make every f32 partial exact,
so engine evaluation order is irrelevant and the finalizer is the only
rounding step on both sides.  For float workloads outside that contract,
construct the auditor with a ``tolerance`` to compare within an absolute
bound instead.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs as _obs
from repro_torch.core.aggregates import AGGREGATES
from repro_torch.core.windows import expr_window_single

__all__ = [
    "AuditFinding", "ShadowAuditor", "WalScrubber",
    "oracle_single", "named_plan_arrays", "plan_crc", "graph_crc",
    "session_digest", "digests_match",
]


# ---------------------------------------------------------------------- #
#  Content digests (crc32, order-stable)
# ---------------------------------------------------------------------- #
def _crc_bytes(crc: int, b: bytes) -> int:
    return zlib.crc32(b, crc) & 0xFFFFFFFF


def _crc_array(crc: int, a) -> int:
    """Fold one array into ``crc``: dtype + shape + raw bytes, so a shape
    or dtype drift is as detectable as a value drift.  A tensor folds as
    its host NumPy copy (its dtype string is NumPy's, as the reference's)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    a = np.asarray(a)
    crc = _crc_bytes(crc, str(a.dtype).encode())
    crc = _crc_bytes(crc, repr(a.shape).encode())
    return _crc_bytes(crc, np.ascontiguousarray(a).tobytes())


def named_plan_arrays(plan) -> Dict[str, object]:
    """The named tensors a plan holds: its ``named_arrays()``, the one
    accessor its ``array_nbytes()`` also reads, so the digest covers every
    array the footprint counts under the same keys.  A
    :class:`~repro_torch.distributed.window_runtime.ShardedDBPlan` names
    the whole canonical layout instead (the flat arrays of every shard,
    under the reference's keys, held on the host by every rank), so its
    digest is the same on every rank and equals the reference's for the
    same plan and shard count; its device shard is derived from them."""
    return plan.named_arrays()


def plan_crc(plan, crc: int = 0) -> int:
    """crc32 over every array of one plan, in sorted key order."""
    arrays = named_plan_arrays(plan)
    for key in sorted(arrays):
        crc = _crc_bytes(crc, key.encode())
        crc = _crc_array(crc, arrays[key])
    return crc


def graph_crc(graph, crc: int = 0) -> int:
    """crc32 over the graph's structural arrays + every attribute."""
    crc = _crc_bytes(crc, f"n={graph.n};directed={graph.directed}".encode())
    crc = _crc_array(crc, graph.src)
    crc = _crc_array(crc, graph.dst)
    for name in sorted(graph.attrs):
        crc = _crc_bytes(crc, name.encode())
        crc = _crc_array(crc, graph.attrs[name])
    return crc


def session_digest(session, include_results: bool = False) -> Dict:
    """Per-version content digest of a :class:`~repro_torch.core.api.Session`.

    Always covers the graph and every live plan; ``include_results=True``
    additionally runs every compiled group once (through the ordinary
    cache-aware snapshot read path — warm executors, no recompiles) and
    folds the result vectors in, turning the digest into an end-to-end
    served-bytes check at the cost of one fused launch per cold group.
    """
    d: Dict = {"version": int(session.version),
               "graph_crc": graph_crc(session.graph)}
    crc = 0
    for (window, kind) in sorted(session._states,
                                 key=lambda k: f"{k[0].name()}/{k[1]}"):
        eng = session._states[(window, kind)]
        crc = _crc_bytes(crc, f"{window.name()}/{kind}".encode())
        if getattr(eng, "plan", None) is not None:
            crc = plan_crc(eng.plan, crc)
    d["plan_crc"] = crc
    if include_results:
        view = session.snapshot()
        crc = 0
        for gi in range(len(session.compiled.groups)):
            out = view.run_group(gi)
            for agg in sorted(out):
                crc = _crc_bytes(crc, f"{gi}:{agg}".encode())
                crc = _crc_array(crc, out[agg])
        d["result_crc"] = crc
    return d


def digests_match(leader: Dict, follower: Dict,
                  check_plans: bool = True) -> Tuple[bool, str]:
    """Compare two session digests component-wise.

    Returns ``(ok, detail)``; only components present on *both* sides are
    compared (a leader that skipped result digests does not fail a
    follower that computed them).  ``check_plans=False`` skips the plan
    component — a replica deliberately running a different engine/layout
    configuration has legitimately different plan bytes while graph and
    result digests must still agree (the bit-identity invariant).
    """
    keys = ["graph_crc", "result_crc"] + (["plan_crc"] if check_plans else [])
    for k in keys:
        if k in leader and k in follower and leader[k] != follower[k]:
            return False, (f"{k}: leader={leader[k]:#010x} "
                           f"follower={follower[k]:#010x}")
    return True, "ok"


# ---------------------------------------------------------------------- #
#  Quarantined findings
# ---------------------------------------------------------------------- #
@dataclasses.dataclass
class AuditFinding:
    """One piece of correctness evidence, quarantined for a human.

    ``source`` says which channel raised it: ``"oracle"`` (shadow
    re-evaluation mismatch), ``"scrub"`` (at-rest WAL CRC failure) or
    ``"digest"`` (leader/follower content-digest divergence).  ``expected``
    / ``got`` hold the raw bytes compared (oracle findings); ``version``
    and ``wal_offset`` attribute the damage (scrub/digest findings carry
    the exact record byte offset in the log).
    """

    source: str
    version: Optional[int] = None
    spec: Optional[str] = None
    vertex: Optional[int] = None
    expected: Optional[bytes] = None
    got: Optional[bytes] = None
    wal_offset: Optional[int] = None
    detail: str = ""
    t_unix_s: float = dataclasses.field(default_factory=time.time)

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        for k in ("expected", "got"):
            if d[k] is not None:
                d[k] = d[k].hex()
        return d


# ---------------------------------------------------------------------- #
#  Independent single-vertex oracle
# ---------------------------------------------------------------------- #
def oracle_single(graph, window, values, agg: str, vertex: int, dtype=None):
    """Set-evaluate one vertex's window aggregate — the reference path.

    Same math as :func:`repro_torch.core.query.brute_force` restricted to one
    vertex: frontier BFS / NumPy set ops for the member set
    (:func:`~repro_torch.core.windows.expr_window_single` handles leaves and
    combinators alike), then a direct monoid reduce and the registered
    finalizer.  ``dtype`` pins the channel dtype — pass the *served*
    result's dtype so the comparison is bitwise on integer-valued
    attributes (f32 partials are exact integers on both sides).
    """
    a = AGGREGATES[agg]
    chans = a.prepare(np.asarray(values))
    if dtype is not None:
        chans = tuple(c.astype(dtype) for c in chans)
    w = expr_window_single(graph, window, int(vertex))
    outs = [
        np.asarray(m.np_op.reduce(c[w]) if w.size else m.identity_for(c.dtype),
                   dtype=c.dtype)
        for m, c in zip(a.monoids, chans)
    ]
    return a.finalize_np(*outs)


# ---------------------------------------------------------------------- #
#  ShadowAuditor
# ---------------------------------------------------------------------- #
class ShadowAuditor:
    """Sample served tickets and re-evaluate them against the oracle.

    ``sample_rate`` is the fraction of successfully served point tickets
    audited (deterministic error-diffusion accumulator — an exact rate,
    not a coin flip, so tests and benches are reproducible);
    ``full_row_rate`` is the per-full-graph-result probability of auditing
    one (deterministically rotating) row of the vector.  ``max_queue``
    bounds the hand-off queue; when the worker falls behind, samples are
    **dropped** (never blocking a flush or a ``Ticket.get``).

    Attach with :meth:`repro_torch.serve.window_service.WindowService.
    attach_auditor` (or call :meth:`bind` directly), then :meth:`start`.
    """

    def __init__(self, sample_rate: float = 0.01,
                 full_row_rate: float = 0.05, max_queue: int = 1024,
                 tolerance: Optional[float] = None, obs=None, tracer=None):
        assert 0.0 <= sample_rate <= 1.0
        assert 0.0 <= full_row_rate <= 1.0
        self.sample_rate = float(sample_rate)
        self.full_row_rate = float(full_row_rate)
        self.tolerance = tolerance
        self.obs = obs if obs is not None else _obs.get_registry()
        self.tracer = tracer if tracer is not None else _obs.get_tracer()
        self.service = None  # bound by attach_auditor / bind
        self._q: "queue.Queue" = queue.Queue(maxsize=int(max_queue))
        self._thread: Optional[threading.Thread] = None
        self._stopping = threading.Event()
        self._findings_lock = threading.Lock()
        self.findings: List[AuditFinding] = []
        # deterministic sampling state (observe_flush runs under the
        # service's flush lock, so no extra lock needed)
        self._acc_point = 0.0
        self._acc_full = 0.0
        self._row_seq = 0
        # telemetry
        self.sampled = 0
        self.audited = 0
        self.mismatches = 0
        self.dropped_samples = 0
        self._m_samples = self.obs.counter(
            "repro_audit_samples_total",
            "shadow-audited samples by outcome", labels=("outcome",))
        self._m_mismatch = self.obs.counter(
            "repro_audit_mismatches_total",
            "served results that differ from the set-eval oracle")
        self._m_dropped = self.obs.counter(
            "repro_audit_dropped_total",
            "audit samples dropped on a full queue (never blocks serving)")
        self._h_lag = self.obs.histogram(
            "repro_audit_lag_seconds",
            "serve-to-verdict latency of audited samples")

    # --------------------------- lifecycle ---------------------------- #
    def bind(self, service) -> "ShadowAuditor":
        self.service = service
        return self

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "ShadowAuditor":
        if not self.running:
            self._stopping.clear()
            self._thread = threading.Thread(
                target=self._worker, name="shadow-auditor", daemon=True)
            self._thread.start()
        return self

    def stop(self, drain: bool = True, timeout: float = 10.0) -> None:
        if drain:
            self.drain(timeout=timeout)
        self._stopping.set()
        if self._thread is not None:
            # unblock the worker's get()
            try:
                self._q.put_nowait(None)
            except queue.Full:
                pass
            self._thread.join(timeout=timeout)
            self._thread = None

    def drain(self, timeout: float = 10.0) -> bool:
        """Block until every queued sample has a verdict (tests/benches);
        returns False on timeout.  Serving never calls this."""
        deadline = time.perf_counter() + timeout
        while self._q.unfinished_tasks:
            if not self.running or time.perf_counter() > deadline:
                return self._q.unfinished_tasks == 0
            time.sleep(0.001)
        return True

    def __enter__(self) -> "ShadowAuditor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # --------------------------- sampling ----------------------------- #
    def observe_flush(self, view, tickets) -> None:
        """Called by the service after a flush (on the serving thread,
        under its flush lock).  O(1) per sampled ticket: captures
        references to immutable snapshot state and enqueues; evaluation
        happens on the worker."""
        if self.service is None:
            return
        compiled = self.service.session.compiled
        for t in tickets:
            if t.error is not None or t.result is None:
                continue
            if t.vertex is not None:
                self._acc_point += self.sample_rate
                if self._acc_point < 1.0:
                    continue
                self._acc_point -= 1.0
                vertex, served = t.vertex, t.result
            else:
                self._acc_full += self.full_row_rate
                if self._acc_full < 1.0:
                    continue
                self._acc_full -= 1.0
                vec = np.asarray(t.result)
                if vec.size == 0:
                    continue
                # deterministic rotating row pick (no RNG: reproducible)
                self._row_seq += 1
                vertex = int((self._row_seq * 7919) % vec.shape[0])
                served = vec[vertex]
            gi, ai = compiled.spec_slots[t.spec_index]
            grp = compiled.groups[gi]
            values = (t.values if t.values is not None
                      else view.graph.attrs[grp.attr])
            sample = {
                "graph": view.graph,
                "window": grp.window,
                "agg": grp.aggs[ai],
                "attr": grp.attr,
                "values": values,
                "vertex": int(vertex),
                "served": np.asarray(served).copy(),
                "version": t.version,
                "t_served": time.perf_counter(),
            }
            self.sampled += 1
            try:
                self._q.put_nowait(sample)
            except queue.Full:
                self.dropped_samples += 1
                self._m_dropped.inc()

    # --------------------------- verdicts ----------------------------- #
    def _worker(self) -> None:
        self.tracer.name_thread()
        while not self._stopping.is_set():
            try:
                sample = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            try:
                if sample is not None:
                    self._audit_one(sample)
            except Exception:
                # the auditor must never take the process down; an
                # evaluation bug shows up as a missing verdict, not a crash
                pass
            finally:
                self._q.task_done()

    def _audit_one(self, s: Dict) -> None:
        served = np.asarray(s["served"])
        expected = np.asarray(
            oracle_single(s["graph"], s["window"], s["values"], s["agg"],
                          s["vertex"], dtype=served.dtype),
            dtype=served.dtype)
        if self.tolerance is None:
            ok = expected.tobytes() == served.tobytes()
        else:
            ok = bool(abs(float(expected) - float(served)) <= self.tolerance)
        self.audited += 1
        self._m_samples.labels("ok" if ok else "mismatch").inc()
        self._h_lag.observe(time.perf_counter() - s["t_served"])
        if ok:
            return
        spec = f"{s['window'].name()}/{s['agg']}@{s['attr']}"
        finding = AuditFinding(
            source="oracle", version=s["version"], spec=spec,
            vertex=s["vertex"], expected=expected.tobytes(),
            got=served.tobytes(),
            detail=f"oracle={expected!r} served={served!r}")
        self.mismatches += 1
        self._m_mismatch.inc()
        with self._findings_lock:
            self.findings.append(finding)
        svc = self.service
        if svc is not None:
            svc.flight.record(
                "audit", spec=spec, vertex=s["vertex"],
                version=s["version"], expected=expected.tobytes().hex(),
                got=served.tobytes().hex())

    # ------------------------------------------------------------------ #
    @property
    def stats(self) -> Dict:
        return {
            "sample_rate": self.sample_rate,
            "full_row_rate": self.full_row_rate,
            "sampled": self.sampled,
            "audited": self.audited,
            "mismatches": self.mismatches,
            "dropped_samples": self.dropped_samples,
            "queued": self._q.qsize(),
            "running": self.running,
            "findings": [f.to_dict() for f in self.findings],
        }


# ---------------------------------------------------------------------- #
#  WAL scrubber
# ---------------------------------------------------------------------- #
class WalScrubber:
    """Background CRC sweep over the sealed region of a write-ahead log.

    Replay only verifies the log when someone replays it; this sweeps the
    *at-rest* file proactively.  Only records wholly below the durable
    high-water mark are judged (an in-flight/torn tail is a crash
    artifact the WAL already tolerates, never corruption), so a clean run
    has **zero false positives** by construction.  ``wal`` may be a live
    :class:`~repro_torch.serve.wal.WriteAheadLog` (sealed = fsynced bytes) or a
    path (sealed = the whole file — use for closed logs).
    """

    def __init__(self, wal, interval_s: float = 0.25, obs=None,
                 tracer=None, flight=None):
        self.wal = wal
        self.interval_s = float(interval_s)
        self.obs = obs if obs is not None else _obs.get_registry()
        self.tracer = tracer if tracer is not None else _obs.get_tracer()
        self.flight = flight
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._reported: set = set()  # record offsets already quarantined
        self.findings: List[AuditFinding] = []
        self.sweeps = 0
        self.records_verified = 0
        self.corruptions = 0
        self._m_sweeps = self.obs.counter(
            "repro_wal_scrub_sweeps_total", "completed scrub sweeps")
        self._m_records = self.obs.counter(
            "repro_wal_scrub_records_total", "records CRC-verified at rest")
        self._m_corrupt = self.obs.counter(
            "repro_wal_scrub_corruptions_total",
            "sealed records failing their CRC (at-rest rot)")

    # ------------------------------------------------------------------ #
    def _path_and_limit(self) -> Tuple[str, int]:
        import os

        if hasattr(self.wal, "synced_size"):
            return self.wal.path, int(self.wal.synced_size)
        path = os.fspath(self.wal)
        try:
            return path, os.path.getsize(path)
        except OSError:
            return path, 0

    def scrub_once(self) -> List[AuditFinding]:
        """One full sweep of the sealed region; returns NEW findings."""
        from repro_torch.serve.wal import (
            _DIG_MAGIC,
            _FILE_MAGIC,
            _REC_HDR,
            _REC_MAGIC,
        )

        path, limit = self._path_and_limit()
        try:
            with open(path, "rb") as f:
                data = f.read(limit)
        except OSError:
            return []
        new: List[AuditFinding] = []
        off = len(_FILE_MAGIC)
        if len(data) < off or data[:off] != _FILE_MAGIC:
            if data and off not in self._reported:
                self._reported.add(0)
                new.append(self._quarantine(None, 0, "bad file header"))
            return new
        while off + _REC_HDR.size <= len(data):
            magic, version, length, crc = _REC_HDR.unpack_from(data, off)
            if magic not in (_REC_MAGIC, _DIG_MAGIC):
                if off not in self._reported:
                    self._reported.add(off)
                    new.append(self._quarantine(
                        None, off, f"bad record magic {magic!r}"))
                break  # cannot trust the length field to skip past
            end = off + _REC_HDR.size + length
            if end > len(data):
                break  # straddles the sealed boundary: judged next sweep
            payload = data[off + _REC_HDR.size: end]
            self.records_verified += 1
            self._m_records.inc()
            if zlib.crc32(payload) & 0xFFFFFFFF != crc:
                if off not in self._reported:
                    self._reported.add(off)
                    new.append(self._quarantine(
                        int(version), off,
                        f"payload crc mismatch in sealed "
                        f"{'digest' if magic == _DIG_MAGIC else 'batch'} "
                        f"record ({length} bytes)"))
            off = end  # header intact: length is trustworthy, keep going
        self.sweeps += 1
        self._m_sweeps.inc()
        return new

    def _quarantine(self, version: Optional[int], offset: int,
                    detail: str) -> AuditFinding:
        f = AuditFinding(source="scrub", version=version, wal_offset=offset,
                         detail=detail)
        self.findings.append(f)
        self.corruptions += 1
        self._m_corrupt.inc()
        if self.flight is not None:
            self.flight.record("scrub", version=version, offset=offset,
                               detail=detail)
        return f

    # --------------------------- lifecycle ---------------------------- #
    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "WalScrubber":
        if not self.running:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="wal-scrubber", daemon=True)
            self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None

    def _loop(self) -> None:
        self.tracer.name_thread()
        while not self._stop.is_set():
            try:
                self.scrub_once()
            except Exception:
                pass  # a scrub bug must never take the service down
            self._stop.wait(self.interval_s)

    def __enter__(self) -> "WalScrubber":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------------ #
    @property
    def stats(self) -> Dict:
        return {
            "sweeps": self.sweeps,
            "records_verified": self.records_verified,
            "corruptions": self.corruptions,
            "interval_s": self.interval_s,
            "running": self.running,
            "findings": [f.to_dict() for f in self.findings],
        }

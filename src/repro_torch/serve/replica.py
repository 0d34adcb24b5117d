"""Read replicas: follower sessions tailing the leader's write-ahead log.

The WAL (:mod:`repro_torch.serve.wal`) is append-before-apply, so its durable
prefix is exactly the leader's update history.  A replica is a follower
:class:`~repro_torch.core.api.Session` built from the same base graph + specs
that *tails the log* — a single file by byte offset, or a rotated
segment directory by ``(segment, offset)`` cursor
(:func:`repro_torch.serve.wal.scan_segmented_entries`): :meth:`ReadReplica.poll`
decodes any newly appended records (a partially appended tail is simply
retried; sealed segments are consumed whole and never skipped) and
applies them through the ordinary incremental maintenance path — the
follower pays the same patch costs as the leader and stays
recompile-free.

Serving is MVCC like the leader's: applied batches advance the follower's
write head, but readers stay **pinned** at the replica's published
snapshot until :meth:`ReadReplica.flip` — a lagging replica keeps serving
a consistent old version (never a half-applied one), and
:meth:`catch_up` = poll + flip.  Results at any published version are
bit-identical to what the leader served at that version: both sides ran
the same batches through the same deterministic maintenance.

Rejoin after a kill is **checkpoint + tail**
(:meth:`ReadReplica.from_checkpoint`): the follower session is rebuilt
from the newest snapshot checkpoint (:mod:`repro_torch.serve.checkpoint`), its
cursor is sought past the checkpoint version
(:func:`repro_torch.serve.wal.seek_segmented`), and only the bounded tail is
replayed.  A cursor pointing below the oldest retained segment raises
:class:`~repro_torch.serve.wal.WalTruncatedError` — the signal that a stale
follower must rejoin through a checkpoint rather than its old offset.

Self-checking: the leader stamps a per-version content digest into the
WAL (:meth:`repro_torch.serve.wal.WriteAheadLog.append_digest`); when
``verify_digests`` is on (the default) the replica recomputes its own
digest whenever a poll lands on the leader's digest for its current head
version and compares (:func:`repro_torch.obs.audit.digests_match`).  The first
disagreement is quarantined as an :class:`~repro_torch.obs.audit.AuditFinding`
on :attr:`ReadReplica.divergence`, attributed to the first bad version
*and* the digest record's WAL byte offset — the health monitor treats it
as a hard failure.  ``check_plan_digest=False`` skips the plan component
for replicas deliberately running a different engine configuration *and*
for checkpoint-restored followers (a freshly built plan legitimately
differs byte-wise from the leader's incrementally patched one; graph and
result digests must still agree: the bit-identity invariant).

Replica metrics are **per-replica labeled** (``{replica="<name>"}`` on
every gauge/counter, Prometheus-exported) and resolve the registry at
call time, so a replica constructed before ``obs.enable()`` still lands
its lag gauges in the live registry afterwards — the same
late-binding rule as the registry's collect-on-scrape gauges.

The follower's session is the port's :class:`~repro_torch.core.api.Session`
(``torch_device=`` among ``session_kw``): its ``update()`` runs the
affected-owner BFS on K2 and its reads run K1.  A tail daemon applies
batches on its own thread while routers flush on theirs; every session
launches on the device's current stream, so a copy-on-write plan clone
is ordered before the patch that follows it with no cross-stream sync.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, Optional, Tuple

from repro_torch import obs as _obs
from repro_torch.core.api import Session
from repro_torch.serve.wal import (
    WalTruncatedError,
    list_segments,
    scan_segmented_entries,
    scan_wal_entries,
    seek_segmented,
)
from repro_torch.serve.window_service import WindowService


class ReadReplica:
    """A follower :class:`Session` + serving front end fed from a WAL.

    ``graph`` and ``specs`` must match what the leader's session was built
    from (the log holds only the *updates*); ``session_kw`` forwards to the
    follower's Session constructor (``torch_device`` among them), so a
    replica may run a different engine/device configuration than the
    leader — the leader may even be the reference package's service, whose
    log format is the port's — results are still
    bit-identical because every engine agrees with the set-evaluation
    semantics.

    ``wal_path`` is a single log file *or* a segment directory (also
    accepts a live ``WriteAheadLog`` / ``SegmentedWriteAheadLog`` — the
    replica tails its files).  ``name`` labels this replica's metrics;
    ``start_version`` resumes version numbering from a checkpoint restore
    (use :meth:`from_checkpoint` rather than passing it directly).
    """

    def __init__(self, graph, specs, wal_path, *, bucket: int = 8,
                 use_cache: bool = True, obs=None,
                 name: str = "replica",
                 verify_digests: bool = True,
                 verify_results: bool = False,
                 check_plan_digest: bool = True,
                 start_version: int = 0, **session_kw):
        if hasattr(wal_path, "directory"):
            wal_path = wal_path.directory
        elif hasattr(wal_path, "path"):
            wal_path = wal_path.path
        self.path = os.fspath(wal_path)
        self.name = str(name)
        self._obs_explicit = obs
        self._segmented = os.path.isdir(self.path)
        self.session = Session(graph, specs, **session_kw)
        if start_version:
            self.session.version = int(start_version)
        #: serving front end pinned behind the apply head (auto_flip off:
        #: publishing is the replica's explicit flip decision)
        self.service = WindowService(self.session, bucket=bucket,
                                     auto_flip=False, use_cache=use_cache,
                                     obs=self.obs)
        self._offset = 0  # single-file mode: next unread byte
        #: segmented mode: (segment base version, byte offset) of the next
        #: unread record
        self._cursor: Tuple[int, int] = (0, 0)
        if self._segmented and start_version:
            self._cursor = seek_segmented(self.path, int(start_version))
        #: version this replica was restored from (0 = built from base)
        self.restored_from_version = int(start_version)
        #: False once :meth:`kill` ran — routers/health exclude the replica
        self.alive = True
        self.records_applied = 0
        self.polls = 0
        #: compare leader digest records against a locally recomputed one
        self.verify_digests = bool(verify_digests)
        #: fold served result vectors into the local digest (end-to-end
        #: served-bytes check; costs one fused launch per group per digest)
        self.verify_results = bool(verify_results)
        #: compare the plan component too — disable when this replica runs
        #: a different engine configuration than the leader
        self.check_plan_digest = bool(check_plan_digest)
        #: first divergence finding (None while leader and follower agree)
        self.divergence = None
        self.digest_checks = 0
        self._tail_thread: Optional[threading.Thread] = None
        self._tail_stop = threading.Event()

    # --------------------------- metrics ------------------------------- #
    @property
    def obs(self):
        """Registry resolved at *call* time (explicit one wins): metrics
        from a replica constructed before ``obs.enable()`` still reach the
        live registry."""
        return (self._obs_explicit if self._obs_explicit is not None
                else _obs.get_registry())

    def _metric(self, kind: str, metric_name: str, help_text: str):
        fam = getattr(self.obs, kind)(metric_name, help_text,
                                      labels=("replica",))
        return fam.labels(self.name)

    # ------------------------------------------------------------------ #
    @property
    def cursor(self) -> Dict:
        """The tailing cursor: ``{"segment": base_version_or_None,
        "offset": byte_offset}``."""
        if self._segmented:
            return {"segment": self._cursor[0], "offset": self._cursor[1]}
        return {"segment": None, "offset": self._offset}

    def _scan(self):
        """New entries past the cursor plus the advanced cursor."""
        if self._segmented:
            try:
                return scan_segmented_entries(self.path, self._cursor)
            except WalTruncatedError:
                # The cursor's segment was truncated away.  That is legal
                # only when this replica had fully consumed it (truncation
                # waits for the slowest *live* cursor's applied version) —
                # re-seek from our own head; a replica genuinely behind
                # the truncation point re-raises here and must rejoin
                # from a checkpoint.
                self._cursor = seek_segmented(
                    self.path, self.session.version)
                return scan_segmented_entries(self.path, self._cursor)
        entries, end = scan_wal_entries(self.path, self._offset)
        return entries, (None, end if entries else max(self._offset, end))

    def poll(self, upto_version: Optional[int] = None) -> int:
        """Apply newly appended WAL records to the follower's write head
        (readers stay pinned).  Returns the number applied.

        ``upto_version`` stops early — a replica can deliberately hold at
        a point-in-time version.  Unconsumed records stay unconsumed (the
        cursor only advances past applied records), so a later poll
        resumes exactly there.

        Digest records encountered along the way are verified against a
        locally recomputed digest when they land on the current head
        version (see ``verify_digests``); the first disagreement is
        quarantined on :attr:`divergence`.  A gap in the version sequence
        (history truncated below the cursor) raises
        :class:`~repro_torch.serve.wal.WalTruncatedError` — rejoin via
        :meth:`from_checkpoint`.
        """
        entries, cursor = self._scan()
        self.polls += 1
        self._metric("counter", "repro_replica_polls_total",
                     "WAL tail polls").inc()
        applied = 0
        stopped = None
        for e in entries:
            if upto_version is not None and e["version"] > upto_version:
                # partial consumption: resume exactly at this record
                stopped = e
                break
            if e["kind"] == "batch":
                if e["version"] > self.session.version + 1:
                    raise WalTruncatedError(
                        f"replica {self.name!r} at version "
                        f"{self.session.version} but next retained record "
                        f"is version {e['version']} — history truncated; "
                        f"rejoin from a checkpoint")
                if e["version"] <= self.session.version:
                    continue  # already folded in (checkpoint restore)
                self.session.update(e["batch"])
                applied += 1
            elif self.verify_digests \
                    and e["version"] == self.session.version:
                self._check_digest(e)
        if stopped is not None:
            cursor = (stopped.get("segment"), stopped["offset"])
        if self._segmented:
            self._cursor = (int(cursor[0]), int(cursor[1]))
        else:
            self._offset = max(self._offset, int(cursor[1]))
        self.records_applied += applied
        self._metric("counter", "repro_replica_records_total",
                     "WAL records applied").inc(applied)
        return applied

    def _check_digest(self, entry: Dict) -> None:
        """Compare the leader's digest record against a fresh local one."""
        from repro_torch.obs.audit import AuditFinding, digests_match

        leader = entry["digest"]
        local = self.session.digest(
            include_results=self.verify_results
            and "result_crc" in leader)
        self.digest_checks += 1
        self._metric(
            "counter", "repro_replica_digest_checks_total",
            "leader digests verified against local recomputation").inc()
        ok, detail = digests_match(leader, local,
                                   check_plans=self.check_plan_digest)
        if ok or self.divergence is not None:
            return
        self.divergence = AuditFinding(
            source="digest", version=int(entry["version"]),
            expected=json.dumps(leader, sort_keys=True).encode(),
            got=json.dumps(local, sort_keys=True).encode(),
            wal_offset=int(entry["offset"]), detail=detail)
        self._metric(
            "counter", "repro_replica_divergence_total",
            "leader/follower digest disagreements (quarantined)").inc()
        self.service.flight.record(
            "divergence", version=int(entry["version"]),
            wal_offset=int(entry["offset"]), detail=detail)

    def flip(self) -> int:
        """Publish the apply head to readers (one snapshot swap)."""
        return self.service.flip()

    def catch_up(self) -> int:
        """Poll to the end of the log, then publish.  Returns the number
        of records applied."""
        n = self.poll()
        self.flip()
        return n

    # --------------------------- background tail ----------------------- #
    @property
    def tailing(self) -> bool:
        return self._tail_thread is not None and self._tail_thread.is_alive()

    def start_tailing(self, interval_s: float = 0.05) -> "ReadReplica":
        """Catch up continuously on a background thread (``replica-tail``)
        until :meth:`stop_tailing`."""
        if not self.tailing:
            self._tail_stop.clear()
            self._tail_thread = threading.Thread(
                target=self._tail_loop, args=(float(interval_s),),
                name=f"replica-tail-{self.name}", daemon=True)
            self._tail_thread.start()
        return self

    def stop_tailing(self, timeout: float = 10.0) -> None:
        self._tail_stop.set()
        if self._tail_thread is not None:
            self._tail_thread.join(timeout=timeout)
            self._tail_thread = None

    def kill(self) -> None:
        """Take this replica out of service (fault injection / retire):
        stops the tail daemon and marks it dead for routers and health."""
        self.alive = False
        self.stop_tailing()

    def _tail_loop(self, interval_s: float) -> None:
        self.service.tracer.name_thread()
        while not self._tail_stop.is_set():
            try:
                self.catch_up()
            except Exception:
                pass  # a tail hiccup must not kill the thread; retry
            self._tail_stop.wait(interval_s)

    # ------------------------------------------------------------------ #
    @property
    def version(self) -> int:
        """The published (reader-visible) version."""
        return self.service.version

    @property
    def head_version(self) -> int:
        """The applied-but-possibly-unpublished version."""
        return self.session.version

    def _behind_bytes(self) -> int:
        """Unconsumed log bytes past the cursor (lag heuristic)."""
        try:
            if not self._segmented:
                return max(os.path.getsize(self.path) - self._offset, 0)
            base, off = self._cursor
            behind = 0
            for b, p in list_segments(self.path):
                size = os.path.getsize(p)
                if b == base:
                    behind += max(size - off, 0)
                elif base == 0 or b > base:
                    behind += size
            return behind
        except OSError:
            return 0

    @property
    def lag(self) -> Dict:
        """How far behind the log this replica is: unapplied bytes in the
        retained segments plus unpublished versions at the head."""
        behind = self._behind_bytes()
        unpublished = self.session.version - self.service.version
        self._metric("gauge", "repro_replica_lag_bytes",
                     "unapplied WAL bytes at last check").set(behind)
        self._metric("gauge", "repro_replica_lag_versions",
                     "applied-but-unpublished versions at last check"
                     ).set(unpublished)
        return {
            "behind_bytes": behind,
            "unpublished_versions": unpublished,
            "published_version": self.service.version,
            "head_version": self.session.version,
        }

    # ------------------------------------------------------------------ #
    @classmethod
    def from_checkpoint(cls, specs, wal_path, checkpoint, *,
                        name: str = "replica", **kw) -> "ReadReplica":
        """Rejoin path: build a replica from the newest checkpoint, cursor
        sought past it, ready to tail only the bounded WAL tail.

        ``checkpoint`` is a checkpoint directory (newest file wins) or a
        single checkpoint file.  The restored follower runs with
        ``check_plan_digest=False`` unless overridden (fresh plan bytes
        legitimately differ from the leader's patched ones); result and
        graph digests still verify.  Raises
        :class:`~repro_torch.serve.wal.WalTruncatedError` via the first
        :meth:`poll` if the tail past the checkpoint was truncated.
        """
        from repro_torch.serve.checkpoint import latest_checkpoint, load_checkpoint

        ckpt = os.fspath(checkpoint)
        if os.path.isdir(ckpt):
            found = latest_checkpoint(ckpt)
            if found is None:
                raise FileNotFoundError(
                    f"no checkpoint under {ckpt!r} to rejoin from")
            ckpt = found[1]
        version, graph, _digest = load_checkpoint(ckpt)
        kw.setdefault("check_plan_digest", False)
        return cls(graph, specs, wal_path, name=name,
                   start_version=version, **kw)

    # ------------------------------- reads ---------------------------- #
    def query(self, spec, vertex: Optional[int] = None, values=None):
        """Serve one read at the published version."""
        return self.service.query(spec, vertex=vertex, values=values)

    @property
    def stats(self) -> Dict:
        out = dict(self.service.stats)
        out.update(name=self.name, alive=self.alive,
                   records_applied=self.records_applied, polls=self.polls,
                   digest_checks=self.digest_checks,
                   diverged=self.divergence is not None,
                   tailing=self.tailing, lag=self.lag, cursor=self.cursor,
                   restored_from_version=self.restored_from_version)
        if self.divergence is not None:
            out["divergence"] = self.divergence.to_dict()
        return out

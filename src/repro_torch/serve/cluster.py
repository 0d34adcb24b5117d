"""Replica cluster tier: one writer, N followers, a freshness router.

This module composes the serving stack's single-node pieces into the
scale-out topology the paper's workload implies (many concurrent readers
over one update stream)::

                         updates
                            │
                            ▼
                 writer AsyncWindowService ──► SegmentedWriteAheadLog
                  (append-before-apply)          (rotated GWAL1 segments)
                            │                      │        │
                     checkpoints ◄─ maybe_checkpoint        │ tail by
               (repro_torch.serve.checkpoint)               │ (segment, offset)
                                               ┌────────────┴───────────┐
                                               ▼                        ▼
                                         ReadReplica r0  ...     ReadReplica rN-1
                                         (auto catch-up daemon, lag gauges)
                                               ▲                        ▲
                                               └──────── WindowRouter ──┘
                                            (freshness + per-class load,
                                             MVCC pinning, failover)

* :class:`ReplicaSet` owns the writer (an
  :class:`~repro_torch.serve.window_service.AsyncWindowService` over a
  :class:`~repro_torch.serve.wal.SegmentedWriteAheadLog`), the follower
  :class:`~repro_torch.serve.replica.ReadReplica`s (each with a background
  auto-catch-up daemon and per-replica labeled lag gauges), periodic
  snapshot checkpoints, and *safe* segment truncation: a sealed segment
  is deleted only once every **live** replica's cursor and the newest
  checkpoint are past it, so no tailing cursor is ever stranded and
  checkpoint+tail recovery always finds a complete tail.  A killed
  replica rejoins through :meth:`ReplicaSet.rejoin` — checkpoint + tail,
  not its stale cursor — and is bitwise-equal to a fresh session at the
  head (the bit-identity invariant).

* :class:`WindowRouter` places reads: writes always go writer → WAL →
  followers; reads go to the **freshest** healthy replica (highest
  published version, optionally constrained by ``min_version`` for
  read-your-writes), tie-broken by least per-class in-flight load.  Each
  ticket is pinned to its replica's published MVCC version — a routed
  read is bitwise-identical to a direct ``Session.run`` replayed to that
  pinned version.  Failover never strands a waiter: when a replica is
  failed out, *exactly its* in-flight tickets get
  :class:`ReplicaFailedError` recorded (their submitters' ``get()``
  raises; nobody blocks forever) and subsequent traffic routes to the
  surviving replicas, falling back to the writer when none qualify.

Router and cluster metrics resolve the registry at call time (the obs
re-enable rule), so a cluster constructed before ``obs.enable()`` still
exports ``repro_router_*`` and per-replica lag after it.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch import obs as _obs
from repro_torch.core.api import Session
from repro_torch.serve.checkpoint import latest_checkpoint, list_checkpoints
from repro_torch.serve.replica import ReadReplica
from repro_torch.serve.wal import SegmentedWriteAheadLog
from repro_torch.serve.window_service import AsyncWindowService, Ticket

__all__ = ["ReplicaFailedError", "ReplicaSet", "RoutingError",
           "WindowRouter"]


class ReplicaFailedError(RuntimeError):
    """The replica serving this ticket was failed out of the cluster
    before the ticket was served.  Retry through the router — it will
    place the retry on a surviving replica."""


class RoutingError(RuntimeError):
    """No target can satisfy the routing constraints (e.g. ``min_version``
    newer than every published snapshot, including the writer's)."""


class ReplicaSet:
    """One writer + N followers sharing a segmented WAL + checkpoints.

    ``directory`` is the cluster's state root: ``wal/`` (rotated
    segments) and ``checkpoints/`` are created inside it.  ``graph`` and
    ``specs`` seed the writer and every base-built follower;
    ``session_kw`` forwards to each session constructor (both sides must
    match for bit-identical digests).

    ``checkpoint_every`` > 0 checkpoints the writer every that many
    versions (and, with ``truncate_on_checkpoint``, immediately drops the
    sealed segments nobody can ever need again).  Deterministic tests
    drive :meth:`update` / :meth:`sync` directly; live deployments call
    :meth:`start` for the flusher + auto-catch-up daemons.
    """

    def __init__(self, graph, specs, directory, *, n_replicas: int = 2,
                 bucket: int = 8, classes=None,
                 default_class: str = "interactive",
                 max_pending: int = 256,
                 rotate_bytes: int = 1 << 20,
                 rotate_records: Optional[int] = None,
                 fsync_every: int = 8,
                 checkpoint_every: int = 0,
                 truncate_on_checkpoint: bool = True,
                 wal_digests: bool = True,
                 replica_kw: Optional[Dict] = None,
                 obs=None, now_fn=None, **session_kw):
        self.directory = os.fspath(directory)
        self.wal_dir = os.path.join(self.directory, "wal")
        self.checkpoint_dir = os.path.join(self.directory, "checkpoints")
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        self._obs_explicit = obs
        self._base_graph = graph
        self._specs = specs
        self._session_kw = dict(session_kw)
        self._replica_kw = dict(replica_kw or {})
        self._bucket = int(bucket)
        self.checkpoint_every = int(checkpoint_every)
        self.truncate_on_checkpoint = bool(truncate_on_checkpoint)
        self.wal = SegmentedWriteAheadLog(
            self.wal_dir, rotate_bytes=rotate_bytes,
            rotate_records=rotate_records, fsync_every=fsync_every,
            obs=obs)
        # the writer's staleness pressure (admission, health) reads the
        # session's own reorganize policy, not the default thresholds
        self.writer = AsyncWindowService(
            Session(graph, specs, **session_kw), bucket=bucket,
            classes=classes, default_class=default_class,
            max_pending=max_pending, wal=self.wal,
            wal_digests=wal_digests, policy=session_kw.get("policy"),
            obs=obs, now_fn=now_fn)
        self.replicas: Dict[str, ReadReplica] = {}
        for i in range(int(n_replicas)):
            self.add_replica(f"r{i}")
        found = latest_checkpoint(self.checkpoint_dir)
        self.last_checkpoint_version = found[0] if found else 0
        self.checkpoints_written = 0
        self.router = WindowRouter(self, obs=obs)

    # ------------------------------------------------------------------ #
    @property
    def obs(self):
        return (self._obs_explicit if self._obs_explicit is not None
                else _obs.get_registry())

    @property
    def version(self) -> int:
        """The writer's head version."""
        return self.writer.session.version

    @property
    def live_replicas(self) -> Dict[str, ReadReplica]:
        return {n: r for n, r in self.replicas.items() if r.alive}

    def add_replica(self, name: Optional[str] = None,
                    **kw) -> ReadReplica:
        """Grow the fleet: a follower built from the base graph that will
        tail the whole retained log (use :meth:`rejoin` to come up from a
        checkpoint instead)."""
        if name is None:
            name = f"r{len(self.replicas)}"
        merged = {**self._session_kw, **self._replica_kw, **kw}
        rep = ReadReplica(self._base_graph, self._specs, self.wal_dir,
                          bucket=self._bucket, name=name,
                          obs=self._obs_explicit, **merged)
        self.replicas[name] = rep
        return rep

    # --------------------------- write path ---------------------------- #
    def update(self, batch) -> Dict:
        """Writer → WAL → (followers tail): apply one batch at the writer
        and run the checkpoint/truncation policy."""
        report = self.writer.update(batch)
        self.maybe_checkpoint()
        return report

    def checkpoint(self) -> Tuple[int, str]:
        """Snapshot the writer now; returns ``(version, path)``."""
        version, path = self.writer.session.save_checkpoint(
            self.checkpoint_dir)
        self.last_checkpoint_version = version
        self.checkpoints_written += 1
        if self.truncate_on_checkpoint:
            self.truncate()
        return version, path

    def maybe_checkpoint(self) -> Optional[Tuple[int, str]]:
        """Checkpoint iff ``checkpoint_every`` versions have passed."""
        if self.checkpoint_every <= 0:
            return None
        if self.version - self.last_checkpoint_version \
                < self.checkpoint_every:
            return None
        return self.checkpoint()

    def safe_truncate_version(self) -> int:
        """The newest version whose history nobody can ever need again:
        ``min(newest checkpoint, slowest *live* replica's applied
        version)``.  Dead replicas are excluded — they rejoin via
        checkpoint + tail, never via their stale cursor.  0 (nothing
        truncatable) until a checkpoint exists: full-replay recovery
        needs the whole log."""
        if self.last_checkpoint_version <= 0:
            return 0
        safe = self.last_checkpoint_version
        for rep in self.live_replicas.values():
            safe = min(safe, rep.head_version)
        return safe

    def truncate(self) -> List[Tuple[int, str]]:
        """Drop sealed segments wholly below :meth:`safe_truncate_version`."""
        return self.wal.truncate_upto(self.safe_truncate_version())

    # --------------------------- follower path -------------------------- #
    def catch_up(self) -> Dict[str, int]:
        """Poll + publish every live replica (deterministic stepping for
        tests; live deployments run the tail daemons instead)."""
        return {name: rep.catch_up()
                for name, rep in self.live_replicas.items()}

    def sync(self) -> Dict[str, int]:
        """Flush the WAL group commit, then catch every follower up."""
        self.wal.sync()
        return self.catch_up()

    # --------------------------- lifecycle ------------------------------ #
    def start(self, tail_interval_s: float = 0.05) -> "ReplicaSet":
        """Start the writer's flusher and every follower's tail daemon."""
        self.writer.start()
        for rep in self.live_replicas.values():
            rep.start_tailing(interval_s=tail_interval_s)
        return self

    def stop(self) -> None:
        for rep in self.replicas.values():
            rep.stop_tailing()
        self.writer.stop(drain=True)

    def close(self) -> None:
        self.stop()
        self.writer.close()

    def __enter__(self) -> "ReplicaSet":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # --------------------------- fault handling ------------------------- #
    def kill(self, name: str) -> int:
        """Fault-inject/retire one replica: stop its daemon, mark it dead,
        and fail over its in-flight tickets.  Returns the number of
        tickets failed over."""
        rep = self.replicas[name]
        rep.kill()
        return self.router.fail_replica(name)

    def rejoin(self, name: str, catch_up: bool = True) -> ReadReplica:
        """Bring a killed (or brand-new) replica back through **checkpoint
        + tail**: rebuild from the newest checkpoint, seek the cursor past
        it, replay only the bounded tail, and return to routing.  Falls
        back to a base-graph build when no checkpoint exists yet."""
        merged = {**self._session_kw, **self._replica_kw}
        if latest_checkpoint(self.checkpoint_dir) is not None:
            rep = ReadReplica.from_checkpoint(
                self._specs, self.wal_dir, self.checkpoint_dir,
                name=name, bucket=self._bucket, obs=self._obs_explicit,
                **merged)
        else:
            rep = ReadReplica(self._base_graph, self._specs, self.wal_dir,
                              bucket=self._bucket, name=name,
                              obs=self._obs_explicit, **merged)
        self.replicas[name] = rep
        if catch_up:
            self.wal.sync()
            rep.catch_up()
        self.router.restore_replica(name)
        return rep

    # ------------------------------------------------------------------ #
    def debug_info(self) -> Dict:
        """Per-replica lag/cursor/liveness + WAL segments + checkpoint
        state (the ``/debug`` payload for the cluster)."""
        return {
            "writer": {
                "version": self.version,
                "running": self.writer.running,
            },
            "replicas": {
                name: {
                    "alive": rep.alive,
                    "tailing": rep.tailing,
                    "lag": rep.lag,
                    "cursor": rep.cursor,
                    "published_version": rep.version,
                    "head_version": rep.head_version,
                    "diverged": rep.divergence is not None,
                    "restored_from_version": rep.restored_from_version,
                } for name, rep in self.replicas.items()
            },
            "wal": self.wal.stats,
            "checkpoints": {
                "last_version": self.last_checkpoint_version,
                "written": self.checkpoints_written,
                "retained": [v for v, _ in
                             list_checkpoints(self.checkpoint_dir)],
            },
            "router": self.router.stats,
        }

    @property
    def stats(self) -> Dict:
        return self.debug_info()


# ---------------------------------------------------------------------- #
class WindowRouter:
    """Route reads across a replica fleet by freshness + per-class load.

    Construct over a :class:`ReplicaSet` (the usual way — the set already
    owns one at ``.router``) or over explicit ``replicas`` (a
    ``{name: ReadReplica}`` dict) + ``writer``.  Placement:

    1. candidates = live, un-failed, un-diverged replicas whose
       *published* version satisfies ``min_version`` (when given);
    2. keep only the freshest (highest published version);
    3. least per-class in-flight load wins (ties: lexical name — stable).

    With no candidate the read falls back to the **writer's** service
    (always at the head); if even the writer cannot satisfy
    ``min_version``, :class:`RoutingError`.  Writes are *not* routed:
    they always go through the writer (``ReplicaSet.update``).
    """

    def __init__(self, replica_set: Optional[ReplicaSet] = None, *,
                 replicas: Optional[Dict[str, ReadReplica]] = None,
                 writer=None, obs=None):
        if replica_set is None and replicas is None:
            raise ValueError("need a ReplicaSet or an explicit replica map")
        self._set = replica_set
        self._replicas = replicas
        self.writer = writer if writer is not None else (
            replica_set.writer if replica_set is not None else None)
        self._obs_explicit = obs
        self._lock = threading.Lock()
        # Tickets compare by value (dataclass) so track them by identity
        self._inflight: Dict[Optional[str], Dict[int, Ticket]] = {}
        self._class_load: Dict[Tuple[Optional[str], str], int] = {}
        self.failed: Set[str] = set()
        self.routed = 0
        self.failovers = 0
        self.failed_tickets = 0

    # ------------------------------------------------------------------ #
    @property
    def obs(self):
        """Registry resolved at call time (the obs re-enable rule)."""
        return (self._obs_explicit if self._obs_explicit is not None
                else _obs.get_registry())

    def targets(self) -> Dict[str, ReadReplica]:
        return (self._set.replicas if self._set is not None
                else self._replicas)

    def _candidates(self, min_version: Optional[int]
                    ) -> Dict[str, ReadReplica]:
        out = {}
        for name, rep in self.targets().items():
            if not rep.alive or name in self.failed \
                    or rep.divergence is not None:
                continue
            if min_version is not None and rep.version < min_version:
                continue
            out[name] = rep
        return out

    def pick(self, request_class: str = "point",
             min_version: Optional[int] = None) -> Optional[str]:
        """The chosen replica name, or None for writer fallback."""
        cands = self._candidates(min_version)
        if not cands:
            return None
        freshest = max(rep.version for rep in cands.values())
        pool = sorted(n for n, rep in cands.items()
                      if rep.version == freshest)
        with self._lock:
            return min(pool, key=lambda n: (
                self._class_load.get((n, request_class), 0), n))

    # ------------------------------------------------------------------ #
    def _track(self, t: Ticket, name: Optional[str], cls: str) -> None:
        t._route_target = name
        t._route_class = cls
        with self._lock:
            self._inflight.setdefault(name, {})[id(t)] = t
            key = (name, cls)
            self._class_load[key] = self._class_load.get(key, 0) + 1
        self.routed += 1
        self.obs.counter(
            "repro_router_requests_total", "reads placed by the router",
            labels=("target", "cls")).labels(name or "writer", cls).inc()

    def _untrack(self, t: Ticket) -> None:
        # caller holds self._lock
        key = (getattr(t, "_route_target", None),
               getattr(t, "_route_class", None))
        n = self._class_load.get(key, 0)
        if n > 1:
            self._class_load[key] = n - 1
        else:
            self._class_load.pop(key, None)

    def prune(self) -> None:
        """Drop finished tickets from the in-flight accounting."""
        with self._lock:
            for name, ts in self._inflight.items():
                done = [k for k, t in ts.items() if t.done]
                for k in done:
                    self._untrack(ts.pop(k))

    def inflight(self, name: Optional[str] = None) -> int:
        self.prune()
        with self._lock:
            if name is not None:
                return len(self._inflight.get(name, ()))
            return sum(len(ts) for ts in self._inflight.values())

    # ------------------------------------------------------------------ #
    def submit(self, spec, vertex: Optional[int] = None, values=None,
               request_class: str = "point",
               min_version: Optional[int] = None,
               target: Optional[str] = None) -> Ticket:
        """Place one read; returns its ticket (served on the next
        :meth:`flush` of its target, or by the target's own flusher).
        The ticket's ``version`` is pinned to the serving snapshot's
        published version at flush time.  ``target`` forces placement
        (tests / sticky sessions)."""
        name = target if target is not None \
            else self.pick(request_class, min_version)
        if name is None:
            if self.writer is None:
                raise RoutingError("no replica qualifies and no writer "
                                   "to fall back to")
            if min_version is not None \
                    and self.writer.version < min_version:
                raise RoutingError(
                    f"min_version {min_version} is newer than every "
                    f"published snapshot (writer at {self.writer.version})")
            t = self.writer.submit(spec, vertex=vertex, values=values,
                                   request_class=request_class)
        else:
            rep = self.targets()[name]
            if not rep.alive or name in self.failed:
                raise ReplicaFailedError(f"replica {name!r} is failed out")
            t = rep.service.submit(spec, vertex=vertex, values=values)
        self._track(t, name, request_class)
        return t

    def flush(self) -> int:
        """Flush every live target with queued work (and the writer).
        Returns the number of tickets served."""
        served = 0
        for name, rep in list(self.targets().items()):
            if not rep.alive or name in self.failed:
                continue
            if rep.service._pending:
                served += len(rep.service.flush("router"))
        if self.writer is not None and self.writer._pending \
                and not self.writer.running:
            served += len(self.writer.flush("router"))
        self.prune()
        return served

    def query(self, spec, vertex: Optional[int] = None, values=None,
              request_class: str = "point",
              min_version: Optional[int] = None,
              timeout: Optional[float] = 30.0):
        """Submit + flush + get: one routed read, served at its target's
        pinned published version."""
        t = self.submit(spec, vertex=vertex, values=values,
                        request_class=request_class,
                        min_version=min_version)
        self.flush()
        return t.get(timeout=timeout)

    # --------------------------- failover ------------------------------ #
    def fail_replica(self, name: str, error: Optional[str] = None) -> int:
        """Take ``name`` out of rotation and fail over **exactly its**
        in-flight tickets: each gets :class:`ReplicaFailedError` recorded
        and its waiter released (submitters retry through the router; the
        other replicas' tickets are untouched).  Returns the number of
        tickets failed."""
        self.failed.add(name)
        rep = self.targets().get(name)
        victims: Dict[int, Ticket] = {}
        if rep is not None:
            victims.update((id(t), t) for t in rep.service._take_pending())
        with self._lock:
            tracked = self._inflight.pop(name, {})
            for t in tracked.values():
                self._untrack(t)
        victims.update((k, t) for k, t in tracked.items() if not t.done)
        n_failed = 0
        for t in victims.values():
            if t.done:
                continue
            t.error = ReplicaFailedError(
                error or f"replica {name!r} failed before serving "
                         f"ticket {t.rid}")
            if t._span is not None:
                t._span.set(ok=False, failover=True).finish()
            t._finish()
            n_failed += 1
        self.failovers += 1
        self.failed_tickets += n_failed
        reg = self.obs
        reg.counter("repro_router_failovers_total",
                    "replicas failed out of rotation").inc()
        reg.counter("repro_router_failover_tickets_total",
                    "in-flight tickets failed by a replica failover"
                    ).inc(n_failed)
        return n_failed

    def restore_replica(self, name: str) -> None:
        """Return a (rejoined) replica to the candidate pool."""
        self.failed.discard(name)

    # ------------------------------------------------------------------ #
    @property
    def stats(self) -> Dict:
        self.prune()
        with self._lock:
            inflight = {name or "writer": len(ts)
                        for name, ts in self._inflight.items() if ts}
            load = {f"{name or 'writer'}/{cls}": n
                    for (name, cls), n in self._class_load.items()}
        for name, n in inflight.items():
            self.obs.gauge("repro_router_inflight",
                           "in-flight routed tickets", labels=("target",)
                           ).labels(name).set(n)
        return {
            "routed": self.routed,
            "failovers": self.failovers,
            "failed_tickets": self.failed_tickets,
            "failed_out": sorted(self.failed),
            "inflight": inflight,
            "class_load": load,
        }

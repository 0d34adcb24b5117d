"""Serving layer: batched LM request engine + window-analytics service.

* :class:`~repro_torch.serve.engine.ServeEngine` — continuous-batching-lite
  over prefill/decode step functions (the LM side of the repo).
* :class:`~repro_torch.serve.window_service.WindowService` — micro-batched,
  versioned, cached front end over a window-analytics
  :class:`~repro_torch.core.api.Session` (point-vertex + full-graph traffic
  against a live update stream; pinned views stay valid across updates by
  copy-on-write device plans).
* :class:`~repro_torch.serve.window_service.AsyncWindowService` — continuous
  batching on top: deadline-driven background flusher, staleness-aware
  backpressure/load shedding, and WAL durability (append-before-apply).
* :class:`~repro_torch.serve.window_service.SLOController` — adapts
  per-class effective delays and the fill threshold from measured
  attainment, within declared bounds, with hysteresis.
* :class:`~repro_torch.serve.wal.WriteAheadLog` — crash-tolerant update log;
  :class:`~repro_torch.serve.wal.SegmentedWriteAheadLog` rotates it into
  base-version-named segments; :meth:`repro_torch.core.api.Session.
  restore_from_wal` replays either.  Byte-compatible with the reference
  package's log.
* :mod:`~repro_torch.serve.checkpoint` — pickle-free snapshot checkpoints
  so recovery is checkpoint-load + bounded tail replay.
* :class:`~repro_torch.serve.replica.ReadReplica` — follower session
  tailing the WAL by byte offset or ``(segment, offset)`` cursor (pinned
  reads, explicit catch-up + flip, digest self-check, checkpoint rejoin).
* :class:`~repro_torch.serve.cluster.ReplicaSet` /
  :class:`~repro_torch.serve.cluster.WindowRouter` — the cluster tier: one
  writer + N auto-catch-up followers, freshness/load routing with MVCC
  pinning and failover, checkpoint + truncation policy.
* :class:`~repro_torch.serve.flight.FlightRecorder` — bounded ring of
  structured serving events, dumped automatically when a ticket fails.
* :class:`~repro_torch.serve.health.HealthMonitor` /
  :class:`~repro_torch.serve.health.HealthServer` — liveness/readiness
  state machine over pressure, lag, SLO, quorum, audit and scrub signals,
  served over stdlib HTTP (``/metrics`` ``/healthz`` ``/readyz``
  ``/debug``).
"""

from repro_torch.serve.checkpoint import (  # noqa: F401
    CheckpointCorruptError,
    CheckpointDigestError,
    latest_checkpoint,
    list_checkpoints,
    load_checkpoint,
    save_checkpoint,
)
from repro_torch.serve.cluster import (  # noqa: F401
    ReplicaFailedError,
    ReplicaSet,
    RoutingError,
    WindowRouter,
)
from repro_torch.serve.engine import Request, ServeEngine  # noqa: F401
from repro_torch.serve.flight import FlightRecorder  # noqa: F401
from repro_torch.serve.health import (  # noqa: F401
    HealthMonitor,
    HealthServer,
    all_monitors,
)
from repro_torch.serve.replica import ReadReplica  # noqa: F401
from repro_torch.serve.wal import (  # noqa: F401
    SegmentedWriteAheadLog,
    WalTruncatedError,
    WriteAheadLog,
    list_segments,
    read_segmented_records,
    read_wal_records,
    replay_wal,
    scan_segmented_entries,
    scan_wal_entries,
    seek_segmented,
)
from repro_torch.serve.window_service import (  # noqa: F401
    DEFAULT_REQUEST_CLASSES,
    AffectedOwnerCache,
    AsyncWindowService,
    LoadShedError,
    RequestClass,
    SLOController,
    Ticket,
    WindowService,
)

"""SLO accounting: per-request-class latency scored against its deadline.

Each :class:`~repro_torch.serve.window_service.RequestClass` carries
``max_delay_ms`` — the continuous-batching deadline the async tier
schedules against.  The SLO question is the measured converse: *of the
tickets actually served in class C, what fraction finished within C's
target, and what are the latency quantiles?*  ROADMAP direction 1's
"measure per-class p99 against ``max_delay_ms`` and adapt" starts here.

:class:`SLOTracker` owns three instrument families in the shared registry
(so the numbers appear in every snapshot/Prometheus export, not a side
channel):

* ``repro_request_latency_seconds{cls}`` — histogram, end-to-end ticket
  latency (submit to finish, the submitter-observed number);
* ``repro_requests_total{cls, outcome}`` — counter, outcomes ``ok`` /
  ``error`` / ``shed``;
* ``repro_slo_within_target_total{cls}`` — counter, ``ok`` tickets whose
  latency was <= the class target.

Attainment is exact (compared per ticket at observe time, not estimated
from buckets); quantiles are the histogram's interpolated estimates.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

__all__ = ["SLOTracker"]


class SLOTracker:
    """Score served tickets against their request class's latency target.

    ``registry`` may be a live :class:`~repro_torch.obs.metrics.MetricsRegistry`
    or a :class:`~repro_torch.obs.metrics.NullRegistry` (every observe becomes a
    no-op and :meth:`report` returns empty classes).
    """

    def __init__(self, registry):
        self.registry = registry
        self._lat = registry.histogram(
            "repro_request_latency_seconds",
            "end-to-end ticket latency (submit to finish)", labels=("cls",))
        self._req = registry.counter(
            "repro_requests_total", "finished tickets by outcome",
            labels=("cls", "outcome"))
        self._within = registry.counter(
            "repro_slo_within_target_total",
            "ok tickets within their class max_delay_ms", labels=("cls",))
        self._targets: Dict[str, Optional[float]] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------------ #
    def observe(self, cls: str, latency_s: float,
                target_s: Optional[float] = None,
                outcome: str = "ok") -> None:
        """Record one finished ticket.  ``target_s`` is the class's
        ``max_delay_ms / 1e3`` (None = no target: latency is recorded,
        attainment is not scored)."""
        if cls not in self._targets or (
                target_s is not None and self._targets.get(cls) is None):
            with self._lock:
                self._targets.setdefault(cls, None)
                if target_s is not None:
                    self._targets[cls] = float(target_s)
        self._req.labels(cls, outcome).inc()
        if outcome != "shed":
            self._lat.labels(cls).observe(latency_s)
        if outcome == "ok" and target_s is not None \
                and latency_s <= target_s:
            self._within.labels(cls).inc()

    # ------------------------------------------------------------------ #
    def counts(self, cls: str) -> Dict[str, float]:
        """Raw cumulative counters for ``cls`` (``ok`` / ``error`` /
        ``shed`` / ``within``) — the delta source for controllers that
        score *windowed* attainment between steps rather than the
        cumulative ratio (:class:`~repro_torch.serve.window_service.
        SLOController`).  All zeros under a :class:`~repro_torch.obs.metrics.
        NullRegistry`."""
        return {
            "ok": float(self._req.labels(cls, "ok").value),
            "error": float(self._req.labels(cls, "error").value),
            "shed": float(self._req.labels(cls, "shed").value),
            "within": float(self._within.labels(cls).value),
        }

    def report(self) -> Dict[str, Dict]:
        """Per-class scorecard: count/ok/error/shed, attainment in [0, 1]
        (ok-and-within-target over ok), and p50/p95/p99 in milliseconds."""
        out: Dict[str, Dict] = {}
        with self._lock:
            targets = dict(self._targets)
        for cls, target in sorted(targets.items()):
            ok = self._req.labels(cls, "ok").value
            err = self._req.labels(cls, "error").value
            shed = self._req.labels(cls, "shed").value
            lat = self._lat.labels(cls)
            out[cls] = {
                "target_ms": None if target is None else target * 1e3,
                "ok": int(ok),
                "error": int(err),
                "shed": int(shed),
                "attainment": (
                    None if target is None
                    else self._within.labels(cls).value / max(ok, 1.0)),
                "p50_ms": lat.quantile(0.50) * 1e3,
                "p95_ms": lat.quantile(0.95) * 1e3,
                "p99_ms": lat.quantile(0.99) * 1e3,
            }
        return out

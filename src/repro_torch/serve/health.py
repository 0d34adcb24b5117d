"""Liveness/readiness for the serving tier, plus a zero-dependency endpoint.

:class:`HealthMonitor` folds every health signal the stack already
produces — staleness pressure, replica lag, SLO attainment, shadow-audit
verdicts, WAL-scrub status, flusher liveness — into one small state
machine:

* ``ready`` — every check passes; route traffic here.
* ``degraded`` — only *soft* checks fail (pressure, lag, SLO): the node
  is falling behind but its answers are still trusted.  Not ready (a
  router should prefer a ready peer) but recoverable without operator
  action.
* ``failed`` — a *hard* check fails: a quarantined correctness finding
  (oracle mismatch, scrub corruption, digest divergence) or a dead
  flusher thread.  Serving bytes whose correctness is in question is
  worse than serving nothing, so hard failures stay down until the
  findings are cleared (operator acknowledges / node is rebuilt).

:class:`HealthServer` exposes it over plain :mod:`http.server` (no
third-party dependency), on an ephemeral port by default:

* ``GET /metrics`` — Prometheus exposition text from the registry;
* ``GET /healthz`` — 200/503 + ``{"live": bool}`` (process liveness);
* ``GET /readyz`` — 200/503 + ``{"ready", "state", "failing": [...]}``;
* ``GET /debug``  — the service ``debug_report()`` + health + audit/scrub
  stats as JSON (the flight-recorder-and-everything dump).

Monitors register in a process-wide weak set (:func:`all_monitors`) so a
failure hook can dump the last health report of every live monitor
alongside the metrics/trace/flight artifacts.  ``/metrics`` is the port's
own registry's exposition text, under the reference's metric names
(``repro_router_*``, ``repro_replica_*``, ``repro_health_*``).
"""

from __future__ import annotations

import json
import threading
import time
import weakref
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Sequence

from repro_torch import obs as _obs

__all__ = ["HealthMonitor", "HealthServer", "all_monitors"]

_MONITORS: "weakref.WeakSet" = weakref.WeakSet()


def all_monitors() -> List["HealthMonitor"]:
    """Every live monitor in the process (weakly tracked)."""
    return list(_MONITORS)


class HealthMonitor:
    """Fold serving-stack signals into liveness/readiness.

    Every input is optional and duck-typed: ``service`` is a
    :class:`~repro_torch.serve.window_service.WindowService` (or Async
    subclass), ``replicas`` are :class:`~repro_torch.serve.replica.ReadReplica`
    objects, ``auditors`` / ``scrubbers`` come from
    :mod:`repro_torch.obs.audit`.  :meth:`check` runs every check fresh and
    returns (and caches) a structured report.
    """

    #: checks whose failure means "falling behind" (degraded), not
    #: "answers untrusted" (failed)
    SOFT_CHECKS = ("pressure", "replica_lag", "slo", "fleet")

    def __init__(self, service=None, replicas: Sequence = (),
                 auditors: Sequence = (), scrubbers: Sequence = (),
                 cluster=None,
                 obs=None, max_pressure: float = 0.9,
                 max_lag_bytes: int = 1 << 20,
                 max_lag_versions: int = 64,
                 min_slo_attainment: float = 0.5,
                 min_slo_samples: int = 20):
        #: a :class:`~repro_torch.serve.cluster.ReplicaSet`: the monitor then
        #: tracks its writer + live fleet (quorum) and ``/debug`` carries
        #: per-replica cursors and checkpoint state
        self.cluster = cluster
        if cluster is not None and service is None:
            service = cluster.writer
        self.service = service
        self.replicas = list(replicas)
        self.auditors = list(auditors)
        self.scrubbers = list(scrubbers)
        self.obs = obs if obs is not None else _obs.get_registry()
        self.max_pressure = float(max_pressure)
        self.max_lag_bytes = int(max_lag_bytes)
        self.max_lag_versions = int(max_lag_versions)
        self.min_slo_attainment = float(min_slo_attainment)
        self.min_slo_samples = int(min_slo_samples)
        self.state = "ready"
        self.last_report: Optional[Dict] = None
        self._g_ready = self.obs.gauge(
            "repro_health_ready", "1 when every readiness check passes")
        self._g_live = self.obs.gauge(
            "repro_health_live", "1 when the serving loop is alive")
        self._m_checks = self.obs.counter(
            "repro_health_checks_total", "health evaluations by state",
            labels=("state",))
        _MONITORS.add(self)

    # ------------------------------------------------------------------ #
    def check(self) -> Dict:
        """Evaluate every check; returns the structured report."""
        checks: Dict[str, Dict] = {}
        svc = self.service

        # liveness: a started-but-dead flusher thread means the serving
        # loop crashed out from under its queue
        live = True
        th = getattr(svc, "_thread", None) if svc is not None else None
        if th is not None and not th.is_alive() \
                and not getattr(svc, "_stopping", False):
            live = False
        checks["flusher"] = {"ok": live, "detail": (
            "flusher alive" if th is not None and live
            else "flusher thread died" if not live
            else "no background flusher (synchronous service)")}

        # soft: staleness pressure
        if svc is not None and hasattr(svc, "pressure"):
            p = float(svc.pressure())
            checks["pressure"] = {
                "ok": p <= self.max_pressure, "value": p,
                "detail": f"staleness pressure {p:.3f} "
                          f"(max {self.max_pressure})"}

        # soft: replica lag / hard: replica divergence.  Dead replicas are
        # not "lagging" — they are counted by the quorum check instead.
        replicas = (list(self.cluster.replicas.values())
                    if self.cluster is not None else self.replicas)
        live_reps = [r for r in replicas if getattr(r, "alive", True)]
        for i, rep in enumerate(replicas):
            if not getattr(rep, "alive", True):
                continue
            lag = rep.lag
            ok = (lag["behind_bytes"] <= self.max_lag_bytes
                  and lag["unpublished_versions"] <= self.max_lag_versions)
            checks[f"replica_lag[{i}]" if len(replicas) > 1
                   else "replica_lag"] = {
                "ok": ok, "value": lag,
                "detail": f"{lag['behind_bytes']}B behind, "
                          f"{lag['unpublished_versions']} unpublished"}
            div = getattr(rep, "divergence", None)
            if div is not None:
                checks[f"replica_divergence[{i}]"
                       if len(replicas) > 1
                       else "replica_divergence"] = {
                    "ok": False,
                    "detail": f"diverged at version {div.version} "
                              f"(wal offset {div.wal_offset}): {div.detail}"}

        # quorum over the fleet: hard-fail when the writer is down or a
        # majority of replicas is dead (no trustworthy capacity left);
        # a dead minority only degrades (soft "fleet" check)
        if replicas and (self.cluster is not None
                         or any(hasattr(r, "alive") for r in replicas)):
            n_live, n_total = len(live_reps), len(replicas)
            dead = [getattr(r, "name", str(i))
                    for i, r in enumerate(replicas)
                    if not getattr(r, "alive", True)]
            checks["quorum"] = {
                "ok": live and 2 * n_live > n_total,
                "value": {"live": n_live, "total": n_total},
                "detail": (f"{n_live}/{n_total} replicas live"
                           + ("" if live else "; writer down")
                           + (f"; dead: {dead}" if dead else ""))}
            if dead and 2 * n_live > n_total:
                checks["fleet"] = {
                    "ok": False, "value": dead,
                    "detail": f"minority down: {dead}"}

        # soft: SLO attainment (only once enough tickets scored)
        if svc is not None and getattr(svc, "slo", None) is not None \
                and getattr(self.obs, "enabled", False):
            worst, worst_cls, scored = 1.0, None, 0
            for cls, row in svc.slo.report().items():
                att = row.get("attainment")
                if att is None or row.get("ok", 0) < self.min_slo_samples:
                    continue
                scored += 1
                if att < worst:
                    worst, worst_cls = att, cls
            if scored:
                checks["slo"] = {
                    "ok": worst >= self.min_slo_attainment, "value": worst,
                    "detail": f"worst attainment {worst:.3f}"
                              + (f" ({worst_cls})" if worst_cls else "")}

        # hard: quarantined correctness findings
        mismatches = sum(a.mismatches for a in self.auditors)
        if self.auditors:
            checks["audit"] = {
                "ok": mismatches == 0, "value": mismatches,
                "detail": f"{mismatches} oracle mismatch(es) quarantined"}
        corruptions = sum(s.corruptions for s in self.scrubbers)
        if self.scrubbers:
            checks["scrub"] = {
                "ok": corruptions == 0, "value": corruptions,
                "detail": f"{corruptions} sealed-WAL corruption(s) found"}
        aud = getattr(svc, "auditor", None) if svc is not None else None
        if aud is not None and aud not in self.auditors:
            checks["audit"] = {
                "ok": aud.mismatches == 0, "value": aud.mismatches,
                "detail": f"{aud.mismatches} oracle mismatch(es) quarantined"}

        # fold into the state machine
        failing = [k for k, c in checks.items() if not c["ok"]]
        hard = [k for k in failing
                if not any(k.startswith(s) for s in self.SOFT_CHECKS)]
        if not live or hard:
            self.state = "failed"
        elif failing:
            self.state = "degraded"
        else:
            self.state = "ready"
        ready = self.state == "ready"
        self._g_ready.set(1 if ready else 0)
        self._g_live.set(1 if live else 0)
        self._m_checks.labels(self.state).inc()
        self.last_report = {
            "live": live,
            "ready": ready,
            "state": self.state,
            "failing": failing,
            "checks": checks,
            "t_unix_s": time.time(),
        }
        return self.last_report

    @property
    def ready(self) -> bool:
        """Readiness as of the last :meth:`check`."""
        return self.state == "ready"

    def report(self) -> Dict:
        """The last report (running a fresh check if there is none)."""
        return self.last_report if self.last_report is not None \
            else self.check()

    def debug_report(self) -> Dict:
        """Everything: health + service debug report + audit/scrub stats."""
        out: Dict = {"health": self.check()}
        if self.service is not None:
            try:
                out["service"] = self.service.debug_report()
            except Exception as e:  # debug must degrade, not 500
                out["service"] = {"error": repr(e)}
        if self.auditors:
            out["auditors"] = [a.stats for a in self.auditors]
        if self.scrubbers:
            out["scrubbers"] = [s.stats for s in self.scrubbers]
        if self.replicas:
            out["replicas"] = [r.stats for r in self.replicas]
        if self.cluster is not None:
            # per-replica lag + (segment, offset) cursors + checkpoint
            # retention — the cluster operator's one-stop dump
            try:
                out["cluster"] = self.cluster.debug_info()
            except Exception as e:  # debug must degrade, not 500
                out["cluster"] = {"error": repr(e)}
        return out


# ---------------------------------------------------------------------- #
#  HTTP endpoint (stdlib only)
# ---------------------------------------------------------------------- #
class HealthServer:
    """Serve a monitor over HTTP.  ``port=0`` binds an ephemeral port
    (read it back from :attr:`port` / :attr:`url` after :meth:`start`)."""

    def __init__(self, monitor: HealthMonitor, host: str = "127.0.0.1",
                 port: int = 0, registry=None):
        self.monitor = monitor
        self.host = host
        self._requested_port = int(port)
        self.registry = registry if registry is not None else monitor.obs
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------ #
    @property
    def port(self) -> Optional[int]:
        return self._httpd.server_address[1] if self._httpd else None

    @property
    def url(self) -> Optional[str]:
        return f"http://{self.host}:{self.port}" if self._httpd else None

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "HealthServer":
        if self.running:
            return self
        monitor, registry = self.monitor, self.registry

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet: health probes are chatty
                pass

            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _json(self, code: int, obj) -> None:
                self._send(code, json.dumps(obj, indent=2,
                                            default=str).encode(),
                           "application/json")

            def do_GET(self):  # noqa: N802  (http.server API)
                try:
                    path = self.path.split("?", 1)[0].rstrip("/") or "/"
                    if path == "/metrics":
                        text = (registry.prometheus()
                                if hasattr(registry, "prometheus") else "")
                        self._send(200, text.encode(),
                                   "text/plain; version=0.0.4")
                    elif path == "/healthz":
                        rep = monitor.check()
                        self._json(200 if rep["live"] else 503,
                                   {"live": rep["live"],
                                    "state": rep["state"]})
                    elif path == "/readyz":
                        rep = monitor.check()
                        self._json(200 if rep["ready"] else 503,
                                   {"ready": rep["ready"],
                                    "state": rep["state"],
                                    "failing": rep["failing"]})
                    elif path == "/debug":
                        self._json(200, monitor.debug_report())
                    else:
                        self._json(404, {"error": "not found", "routes": [
                            "/metrics", "/healthz", "/readyz", "/debug"]})
                except Exception as e:
                    try:
                        self._json(500, {"error": repr(e)})
                    except Exception:
                        pass

        self._httpd = ThreadingHTTPServer((self.host, self._requested_port),
                                          _Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="health-endpoint", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self) -> "HealthServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

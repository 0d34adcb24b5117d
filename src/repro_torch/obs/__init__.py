"""Observability for the serving stack: metrics, tracing, SLO accounting.

Off by default.  The module-level registry/tracer are the null
implementations until :func:`enable` swaps in live ones, so the serving
hot path pays one no-op method call per event site and tier-1 perf is
untouched.  Instrumented classes capture the globals at construction
(``obs=None`` / ``tracer=None`` params fall back to them); call
:func:`enable` *before* building sessions/services you want observed.

Typical use::

    from repro_torch import obs
    reg, tracer = obs.enable()
    ...  # build Session / WindowService / WAL — they pick up the globals
    print(reg.prometheus())
    tracer.dump("trace.json")          # load in chrome://tracing / Perfetto
    obs.disable()

Setting ``REPRO_OBS=1`` in the environment enables live instrumentation
at import time — handy for running existing test suites instrumented.

Metric-name schema (keep future PRs consistent):

* prefix ``repro_``; counters end ``_total``; durations are histograms
  ending ``_seconds``; sizes end ``_bytes`` / ``_records``; gauges are
  bare nouns (``repro_service_pressure``).
* label keys in use: ``cls`` (request class), ``outcome`` (ok|error|shed),
  ``reason`` (fill|deadline|manual), ``action`` (maintenance decision),
  ``kind`` (index kind), ``event`` (cache hit|miss|invalidate|evict).
* one family per concept — prefer a label over a name suffix
  (``repro_flushes_total{reason=...}``, not three counters).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

from .metrics import (  # noqa: F401
    DEFAULT_LATENCY_BUCKETS_S,
    DEFAULT_SIZE_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    NullRegistry,
)
from .slo import SLOTracker  # noqa: F401
from .tracing import NullTracer, Span, Tracer  # noqa: F401

__all__ = [
    "MetricsRegistry", "NullRegistry", "Counter", "Gauge", "Histogram",
    "Tracer", "NullTracer", "Span", "SLOTracker",
    "DEFAULT_LATENCY_BUCKETS_S", "DEFAULT_SIZE_BUCKETS",
    "get_registry", "get_tracer", "enable", "disable",
    "explain_session", "analyze_session", "PlanReport", "AnalyzeReport",
]


def __getattr__(name):
    # lazy: explain/profile import the plan classes they inspect (and
    # torch); keep plain `import repro_torch.obs` cheap
    if name in ("explain_session", "PlanReport"):
        from . import explain as _explain
        return getattr(_explain, name)
    if name in ("analyze_session", "AnalyzeReport"):
        from . import profile as _profile
        return getattr(_profile, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


_NULL_REGISTRY = NullRegistry()
_NULL_TRACER = NullTracer()

_registry = _NULL_REGISTRY
_tracer = _NULL_TRACER


def get_registry():
    """The process-wide default registry (Null until :func:`enable`)."""
    return _registry


def get_tracer():
    """The process-wide default tracer (Null until :func:`enable`)."""
    return _tracer


def enable(registry: Optional[MetricsRegistry] = None,
           tracer: Optional[Tracer] = None) -> Tuple[MetricsRegistry, Tracer]:
    """Install live defaults (fresh ones unless passed in) and return them.

    Only affects objects constructed afterwards — instrumented classes
    capture the registry/tracer once, at ``__init__``.
    """
    global _registry, _tracer
    _registry = registry if registry is not None else MetricsRegistry()
    _tracer = tracer if tracer is not None else Tracer()
    _install_collectors(_registry, _tracer)
    return _registry, _tracer


def _install_collectors(reg, tracer) -> None:
    """Collect-on-scrape gauges: values that live outside the registry are
    pulled fresh at every ``snapshot()``/``prometheus()`` instead of
    relying on the last manual fold."""
    if not getattr(reg, "enabled", False):
        return

    def _collect_recompiles(r):
        # lazy import: core.api imports repro_torch.obs at module top, so a
        # top-level import here would be circular
        from repro_torch.core import api as _api
        r.gauge(
            "repro_recompiles",
            help="distinct plan shape signatures run by the fused executor",
        ).set(_api.recompile_count())

    # the drop-delta high-water marks live on the *registry*, keyed per
    # tracer: re-running enable() with the same registry + tracer must not
    # reset the seen-state (a fresh closure restarting at 0 would fold the
    # whole historical drop count in again — double counting).  collect()
    # itself replaces by name, so the collector never stacks either.
    seen_map = reg.__dict__.setdefault("_trace_drop_seen", {})
    seen_map.setdefault(id(tracer), 0)

    def _collect_trace_drops(r):
        r.counter(
            "repro_trace_spans_dropped_total",
            help="trace events evicted from the ring buffer on overflow",
        )
        # counters are monotonic: fold in only the delta since last scrape
        now = int(getattr(tracer, "dropped_hint", 0))
        if now > seen_map[id(tracer)]:
            r.counter("repro_trace_spans_dropped_total").inc(
                now - seen_map[id(tracer)])
            seen_map[id(tracer)] = now

    reg.collect(_collect_recompiles, name="recompiles")
    reg.collect(_collect_trace_drops, name="trace_drops")


def disable() -> None:
    """Restore the no-op defaults (existing live handles keep recording)."""
    global _registry, _tracer
    _registry = _NULL_REGISTRY
    _tracer = _NULL_TRACER


# REPRO_OBS=1 enables live instrumentation at import time — the switch for
# running whole existing suites instrumented (bit-identity under obs):
#   REPRO_OBS=1 PYTHONPATH=src python -m pytest -q tests/test_torch_*.py
# Tests that assert on a *fresh* registry (tests/test_obs.py) manage their
# own enable/disable and are unaffected by the startup default.
if os.environ.get("REPRO_OBS", "") not in ("", "0"):
    enable()

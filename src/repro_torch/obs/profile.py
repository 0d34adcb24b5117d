"""ANALYZE for compiled window plans: one profiled execution, per-phase.

``analyze_session(session)`` (surfaced as :meth:`Session.analyze`) runs
the session's compiled groups **once** under a phase-decomposed scope and
returns an :class:`AnalyzeReport` attributing wall time to named phases.
The phases are the port's own launches, not a finer split of them:

* device DBIndex terms: ``host_prep`` (the float32 cast and the upload)
  → ``pass1_reduce`` (one K1 launch over the stacked value and square
  columns, the gather fused in; plus the ELL min/max reduce when the plan
  has ELL layouts) → ``pass2_reduce`` (one K1 launch) → ``finalize``
  (finalizers and the copy back).  K1 fuses both gathers, so there is no
  gather phase;
* device I-Index terms: ``host_prep`` → ``wd_reduce`` (one K1 launch on
  the window-difference plan) → ``inherit`` (one scan launch over every
  column) → ``finalize``;
* host and stateless terms run as one ``materialize`` phase (their
  internals live behind a runner boundary);
* algebraic programs add a ``host_combine`` phase;
* each group's input staging (artifact lookup, attribute selection) is
  charged to a group-level ``host_prep`` phase rather than hiding in the
  residue.

The phases call the very pass functions the fused executors call
(:func:`~repro_torch.core.engine_torch.dbindex_pass1` and ``_pass2``,
``iindex_wd_reduce`` and ``iindex_inherit``), so they launch the same
kernels through the same wrappers and their results are ``run()``'s bit
for bit; they bypass the executors' signature bookkeeping, so ANALYZE
never moves :func:`~repro_torch.core.api.recompile_count`.  On the card
every phase ends in ``torch.cuda.synchronize`` before its clock stops, so
a phase owns its own device work and the sum of phase times accounts for
the profiled wall time up to the Python glue between phases.  Spans are
also emitted on the session's tracer (one ``analyze.phase`` span per
phase) so a Chrome trace shows the same decomposition.

The groups run on one :meth:`~repro_torch.core.api.Session.snapshot`, so
an update on another thread patches a clone rather than a plan a phase is
reading.  Each group's results (``{agg: array}``) are kept on
:attr:`AnalyzeReport.results` and left out of its JSON.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Dict, List

import torch

from repro_torch.core.aggregates import TORCH_XP, pack_channels
from repro_torch.core.engine_torch import (
    _as_values,
    dbindex_pass1,
    dbindex_pass2,
    iindex_inherit,
    iindex_wd_reduce,
)

__all__ = ["AnalyzeReport", "analyze_session"]


@dataclasses.dataclass
class AnalyzeReport:
    """One profiled run: phases, totals, and attribution quality."""

    wall_s: float
    phases: List[Dict]  # [{group, term, phase, seconds}]
    attributed_s: float
    attribution: float  # attributed_s / wall_s
    phase_totals: Dict  # phase name -> seconds summed across terms
    cache: Dict  # result-cache attribution (empty if none attached)
    version: int
    #: per analyzed group index, its results ``{agg: array}`` (as run())
    results: Dict = dataclasses.field(default_factory=dict, repr=False)

    def to_dict(self) -> Dict:
        out = dataclasses.asdict(dataclasses.replace(self, results={}))
        del out["results"]
        return out

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True, **kw)

    def text(self) -> str:
        L = [f"ANALYZE: wall={self.wall_s * 1e3:.3f} ms, "
             f"attributed={self.attributed_s * 1e3:.3f} ms "
             f"({self.attribution * 100:.1f}%), version={self.version}"]
        width = max((len(p) for p in self.phase_totals), default=10)
        for name, sec in sorted(self.phase_totals.items(),
                                key=lambda kv: -kv[1]):
            share = sec / self.wall_s if self.wall_s else 0.0
            L.append(f"  {name:<{width}}  {sec * 1e3:9.3f} ms  "
                     f"{share * 100:5.1f}%")
        for p in self.phases:
            L.append(f"    group {p['group']} term {p['term']} "
                     f"{p['phase']}: {p['seconds'] * 1e3:.3f} ms")
        if self.cache:
            L.append(f"  cache: {self.cache}")
        return "\n".join(L)


class _PhaseClock:
    """Collects (group, term, phase) -> seconds; on the card, synchronizes
    the device inside the timed region so a phase owns its own launches."""

    def __init__(self, tracer, device: torch.device):
        self.rows: List[Dict] = []
        self._tracer = tracer
        self._device = device if device.type == "cuda" else None

    def timed(self, group: int, term: str, phase: str, fn):
        with self._tracer.span("analyze.phase", cat="analyze",
                               phase=phase, term=term):
            t0 = time.perf_counter()
            out = fn()
            if self._device is not None:
                torch.cuda.synchronize(self._device)
            dt = time.perf_counter() - t0
        self.rows.append({"group": group, "term": term, "phase": phase,
                          "seconds": dt})
        return out


# ---------------------------------------------------------------------- #
#  Phase-decomposed executions (the fused executors' own pass functions)
# ---------------------------------------------------------------------- #
def _host_prep(clock: _PhaseClock, gi: int, tname: str, plan, values, aggs):
    """The channel pack, and the attribute vector as one float32 column on
    the plan's device."""
    return clock.timed(gi, tname, "host_prep", lambda: (
        pack_channels(tuple(aggs)), _as_values(values, plan.device)[:, None]))


def _finalize(clock: _PhaseClock, gi: int, tname: str, pack, chans, aggs):
    return clock.timed(gi, tname, "finalize", lambda: {
        a: pack.finalize(i, tuple(c[:, 0] for c in chans), xp=TORCH_XP).cpu().numpy()
        for i, a in enumerate(aggs)})


def _analyze_dbindex_term(clock: _PhaseClock, gi: int, tname: str, plan,
                          values, aggs, opts) -> Dict:
    pack, cols = _host_prep(clock, gi, tname, plan, values, aggs)
    t_cols = clock.timed(gi, tname, "pass1_reduce",
                         lambda: dbindex_pass1(plan, cols, pack))
    chans = clock.timed(gi, tname, "pass2_reduce",
                        lambda: dbindex_pass2(plan, t_cols, pack))
    return _finalize(clock, gi, tname, pack, chans, aggs)


def _analyze_iindex_term(clock: _PhaseClock, gi: int, tname: str, plan,
                         values, aggs, opts) -> Dict:
    schedule = opts.get("schedule", "level")
    pack, cols = _host_prep(clock, gi, tname, plan, values, aggs)
    mat = clock.timed(gi, tname, "wd_reduce",
                      lambda: iindex_wd_reduce(plan, cols, pack))
    chans = clock.timed(gi, tname, "inherit",
                        lambda: iindex_inherit(plan, mat, pack, schedule))
    return _finalize(clock, gi, tname, pack, chans, aggs)


_DEVICE_TERMS = {"DBIndexPlan": _analyze_dbindex_term,
                 "IIndexPlan": _analyze_iindex_term}


# ---------------------------------------------------------------------- #
def analyze_session(session, spec=None, values=None) -> AnalyzeReport:
    """Execute the selected groups once, phase-profiled (see module doc).

    ``spec`` filters like :func:`~repro_torch.obs.explain.explain_session`;
    ``values`` overrides the graph attribute(s) as in ``Session.run``.
    """
    from repro_torch.core.api import _combine_program
    from repro_torch.obs.explain import _match_groups

    clock = _PhaseClock(session.tracer, session.torch_device)
    cache_before = _cache_stats(session)
    view = session.snapshot()
    # labels and dispatch resolved before the clock starts: bookkeeping,
    # not execution
    plan_of = [(gi, session.compiled.groups[gi], session._programs[gi],
                [t.name() for t in session._group_terms(gi)])
               for gi in _match_groups(session, spec)]
    results = {}
    t_start = time.perf_counter()
    for gi, grp, prog, names in plan_of:
        def _prep(gi=gi, grp=grp):
            return (view.artifacts[gi],
                    session._values_for(grp, values, graph=view.graph))

        arts, vals = clock.timed(gi, "-", "host_prep", _prep)
        aggs = prog.term_aggs if prog is not None else grp.aggs
        term_outs = []
        for term, tname, (index, plan) in zip(session._group_terms(gi), names, arts):
            run_term = _DEVICE_TERMS.get(type(plan).__name__)
            if run_term is not None:
                out = run_term(clock, gi, tname, plan, vals, aggs,
                               session._opts)
            else:
                # host / stateless: the runner is the phase — its
                # internals live behind a runner boundary
                out = clock.timed(
                    gi, tname, "materialize",
                    lambda term=term, index=index, plan=plan:
                        session._exec_term(grp, term, index, plan, vals,
                                           view.graph, aggs))
            term_outs.append(out)
        if prog is not None:
            results[gi] = clock.timed(
                gi, "-", "host_combine",
                lambda: _combine_program(prog, grp.aggs, term_outs))
        else:
            results[gi] = term_outs[0]
    wall = time.perf_counter() - t_start

    attributed = sum(p["seconds"] for p in clock.rows)
    totals: Dict[str, float] = {}
    for p in clock.rows:
        totals[p["phase"]] = totals.get(p["phase"], 0.0) + p["seconds"]
    return AnalyzeReport(
        wall_s=wall,
        phases=clock.rows,
        attributed_s=attributed,
        attribution=(attributed / wall) if wall > 0 else 1.0,
        phase_totals=totals,
        cache=_cache_delta(cache_before, _cache_stats(session)),
        version=int(view.version),
        results=results,
    )


def _cache_stats(session) -> Dict:
    cache = getattr(session, "_result_cache", None)
    if cache is None:
        return {}
    out = {}
    for k in ("hits", "misses", "invalidations", "evictions"):
        v = getattr(cache, k, None)
        if v is not None:
            out[k] = int(v)
    return out


def _cache_delta(before: Dict, after: Dict) -> Dict:
    if not after:
        return {}
    out = {k: after[k] for k in after}
    hits = after.get("hits", 0)
    misses = after.get("misses", 0)
    out["hit_rate"] = hits / max(hits + misses, 1)
    out["during_run"] = {k: after[k] - before.get(k, 0) for k in after}
    return out

"""EXPLAIN for compiled window plans: structure without execution.

``explain_session(session)`` (surfaced as :meth:`Session.explain`) walks a
live :class:`~repro_torch.core.api.Session` and returns a
:class:`PlanReport` answering the *why* questions the metric counters
cannot:

* **engine resolution** — which capability won each plan group, and why
  every other registered capability lost (window kind not served,
  aggregates not covered, sharded-flag mismatch, or simply lower
  priority): ``torch`` (the DBIndex device plan, K1 and K2) at priority
  50, ``torch-iindex`` (K1, then the inheritance scan) at 60,
  ``torch-sharded`` (the sharded DBIndex plan of a mesh session) at 70,
  and the host engines below them;
* **lowering choice** — per (expression, monoid set): direct leaf
  materialization, generic composite materialization (with the exact
  planner reason the algebraic fast path was rejected), idempotent
  combine, or pairwise inclusion–exclusion (with the rejected alternative
  named);
* **plan anatomy** — per materialized term: blocks, tile groups, ELL
  layouts, headroom utilization (real vs padded rows), garbage fraction;
  for the I-Index plan also the depth and chain count of the PID forest
  the scan walks; for a sharded plan the shard count, rows per shard,
  shard balance and the patch ledger;
* **memory footprint** — exact per-array device bytes via the plan
  classes' ``array_nbytes()`` / ``plan_nbytes()`` (``numel() *
  element_size()`` of every tensor the plan names in ``named_arrays()``).

Everything here is read-only introspection of host metadata and tensor
shapes: no kernel is launched and no query signature is recorded, so
EXPLAIN can never perturb the zero-respecialization or bit-identity
invariants it reports on.  A sharded plan's footprint is this rank's
device shard; its anatomy reads the host layout every rank holds.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["PlanReport", "GroupReport", "TermReport", "explain_session"]


# ---------------------------------------------------------------------- #
#  Report dataclasses
# ---------------------------------------------------------------------- #
@dataclasses.dataclass
class TermReport:
    """Anatomy + footprint of one materialized term (index, plan) pair."""

    window: str
    index_kind: Optional[str]  # dbindex | iindex | eagr | None (stateless)
    index: Dict  # host index anatomy
    plan_kind: Optional[str]  # DBIndexPlan | IIndexPlan | ShardedDBPlan | None
    plan: Dict  # device plan anatomy
    array_nbytes: Dict  # name -> exact device bytes
    plan_nbytes: int  # sum of the above
    state: Dict  # streaming-state telemetry (version, staleness, reorgs)

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class GroupReport:
    """One fused plan group: resolution, lowering, and its terms."""

    window: str
    window_kind: str
    attr: str
    aggs: Tuple[str, ...]
    engine: str
    capability: Dict
    candidates: List[Dict]  # every registered capability + accept/reject
    lowering: Dict  # choice, reason, rejected alternatives
    terms: List[TermReport]
    group_nbytes: int

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["terms"] = [t.to_dict() for t in self.terms]
        return d


@dataclasses.dataclass
class PlanReport:
    """The full EXPLAIN output for one session."""

    n_vertices: int
    n_edges: int
    version: int
    sharded: bool
    groups: List[GroupReport]
    total_plan_nbytes: int

    def to_dict(self) -> Dict:
        return {
            "n_vertices": self.n_vertices,
            "n_edges": self.n_edges,
            "version": self.version,
            "sharded": self.sharded,
            "total_plan_nbytes": self.total_plan_nbytes,
            "groups": [g.to_dict() for g in self.groups],
        }

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True, **kw)

    # ------------------------------------------------------------------ #
    def text(self) -> str:
        """Human-readable rendering (the ``EXPLAIN`` console view)."""
        L: List[str] = []
        L.append(f"Session: n={self.n_vertices} vertices, m={self.n_edges} "
                 f"edges, version={self.version}, sharded={self.sharded}")
        L.append(f"Total device plan footprint: "
                 f"{_fmt_bytes(self.total_plan_nbytes)}")
        for gi, g in enumerate(self.groups):
            L.append("")
            L.append(f"Group {gi}: {g.window} [{g.window_kind}] "
                     f"attr={g.attr!r} aggs={list(g.aggs)}")
            L.append(f"  engine: {g.engine} (priority "
                     f"{g.capability.get('priority')})")
            for c in g.candidates:
                if c["name"] == g.engine:
                    continue
                L.append(f"    rejected {c['name']}: {c['reason']}")
            low = g.lowering
            L.append(f"  lowering: {low['choice']} — {low['reason']}")
            for alt in low.get("rejected", ()):
                L.append(f"    rejected {alt['choice']}: {alt['reason']}")
            for t in g.terms:
                L.append(f"  term {t.window}: index={t.index_kind} "
                         f"plan={t.plan_kind} "
                         f"footprint={_fmt_bytes(t.plan_nbytes)}")
                for k, v in sorted(t.index.items()):
                    L.append(f"    index.{k}: {v}")
                for k, v in sorted(t.plan.items()):
                    L.append(f"    plan.{k}: {v}")
                for k, v in sorted(t.array_nbytes.items()):
                    L.append(f"    bytes.{k}: {v}")
                if t.state:
                    L.append(f"    state: {t.state}")
            L.append(f"  group footprint: {_fmt_bytes(g.group_nbytes)}")
        return "\n".join(L)


def _fmt_bytes(nb: int) -> str:
    x = float(nb)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if x < 1024 or unit == "GiB":
            return f"{x:.1f} {unit}" if unit != "B" else f"{int(x)} B"
        x /= 1024
    return f"{int(nb)} B"


# ---------------------------------------------------------------------- #
#  Engine resolution
# ---------------------------------------------------------------------- #
def _candidate_rows(session, grp) -> List[Dict]:
    """Accept/reject verdict for every registered capability against this
    group's (window, aggs) — re-deriving what ``EngineRegistry.select``
    saw, with the winner marked and every loser given a concrete reason."""
    from repro_torch.core.api import window_kind

    chosen = session.registry.capability(grp.engine)
    kind = window_kind(grp.window)
    aggset = set(grp.aggs)
    rows = []
    for cap in session.registry.capabilities():
        row = {
            "name": cap.name,
            "priority": cap.priority,
            "windows": list(cap.windows),
            "device": cap.device,
            "sharded": cap.sharded,
            "incremental": cap.incremental,
        }
        if cap.name == chosen.name:
            row["selected"] = True
            row["reason"] = "selected (highest-priority cover)"
        elif kind not in cap.windows:
            row["selected"] = False
            row["reason"] = (f"window kind {kind!r} not served "
                             f"(serves {list(cap.windows)})")
        elif not aggset <= cap.aggregates:
            missing = sorted(aggset - set(cap.aggregates))
            row["selected"] = False
            row["reason"] = f"aggregates not covered: {missing}"
        elif cap.sharded != chosen.sharded:
            row["selected"] = False
            row["reason"] = ("requires a device mesh (sharded)"
                             if cap.sharded else
                             "not sharded — session runs on a mesh")
        elif cap.priority < chosen.priority:
            row["selected"] = False
            row["reason"] = (f"covers the query but priority "
                             f"{cap.priority} < {chosen.priority}")
        else:
            row["selected"] = False
            row["reason"] = "covers the query; not selected (explicit pin)"
        rows.append(row)
    return rows


# ---------------------------------------------------------------------- #
#  Lowering choice
# ---------------------------------------------------------------------- #
def _lowering_report(session, gi: int) -> Dict:
    """The per-(expression, monoid set) lowering decision, re-deriving the
    planner's rejection reason when the algebraic fast path was skipped."""
    from repro_torch.core.api import (
        CHANNEL_AGG,
        Union,
        _group_channels,
        _kind_of,
        window_kind,
    )

    grp = session.compiled.groups[gi]
    prog = session._programs[gi]
    kind = window_kind(grp.window)
    if prog is not None:
        incl_excl = any(c == -1 for c in prog.sum_coefs)
        choice = ("inclusion-exclusion" if incl_excl
                  else "idempotent-combine")
        rep = {
            "choice": choice,
            "reason": (
                "sum-monoid channels ride Σ(A∪B) = Σ(A) + Σ(B) − Σ(A∩B); "
                "only the intersection is extra-materialized"
                if incl_excl else
                "all requested channels are idempotent monoids — pointwise "
                "combine over the children's materializations"
            ),
            "terms": [t.name() for t in prog.terms],
            "term_aggs": list(prog.term_aggs),
            "sum_coefs": list(prog.sum_coefs),
            "rejected": [{
                "choice": "generic-materialization",
                "reason": "algebraic fast path available — avoids "
                          "materializing the composite's window sets",
            }],
        }
        if incl_excl:
            rep["rejected"].append({
                "choice": "idempotent-combine",
                "reason": "a sum-monoid channel is requested; union "
                          "cardinalities overlap, so pointwise combine "
                          "would double-count",
            })
        return rep
    # prog is None — reconstruct why plan_window_program declined
    if kind != "composite":
        return {
            "choice": "direct",
            "reason": f"leaf window ({kind}) — materialized directly by "
                      f"the {grp.engine!r} runner",
            "terms": [grp.window.name()],
            "rejected": [],
        }
    if _kind_of(grp.engine) != "dbindex":
        reason = (f"engine {grp.engine!r} is not dbindex-backed; algebraic "
                  f"programs lower only onto dbindex materializations")
    elif not isinstance(grp.window, Union):
        reason = ("composite is not a Union — only unions admit an "
                  "algebraic decomposition (idempotent combine / "
                  "inclusion–exclusion)")
    else:
        channels = _group_channels(grp.aggs)
        bad = [ch for ch in channels if ch not in CHANNEL_AGG]
        has_sum = any(m == "sum" for m, _ in channels)
        if bad:
            reason = (f"channel(s) {bad} have no canonical per-term "
                      f"aggregate")
        elif has_sum and len(grp.window.exprs) != 2:
            reason = (f"union has {len(grp.window.exprs)} children with a "
                      f"sum-monoid channel; inclusion–exclusion is kept "
                      f"pairwise (2^n terms otherwise)")
        else:  # defensive: mirrors plan_window_program returning a program
            reason = "planner declined (unrecognized shape)"
    return {
        "choice": "generic-materialization",
        "reason": reason,
        "terms": [grp.window.name()],
        "rejected": [{
            "choice": "algebraic-program",
            "reason": reason,
        }],
    }


# ---------------------------------------------------------------------- #
#  Plan anatomy + footprint
# ---------------------------------------------------------------------- #
def _index_anatomy(index) -> Tuple[Optional[str], Dict]:
    if index is None:
        return None, {}
    cls = type(index).__name__
    if cls == "DBIndex":
        from repro_torch.core.streaming import garbage_block_fraction

        sizes = np.diff(index.block_offsets)
        return "dbindex", {
            "n": int(index.n),
            "num_blocks": int(index.num_blocks),
            "member_rows": int(index.block_members.size),
            "link_rows": int(index.link_block.size),
            "mean_block_size": (float(sizes.mean()) if sizes.size else 0.0),
            "max_block_size": (int(sizes.max()) if sizes.size else 0),
            "garbage_fraction": float(garbage_block_fraction(index)),
        }
    if cls == "IIndex":
        return "iindex", {
            "n": int(index.n),
            "wd_rows": int(index.wd_members.size),
            "max_level": (int(index.level.max()) if index.n else 0),
        }
    return cls.lower(), {"type": cls}


def _plan_anatomy(plan, index) -> Tuple[Optional[str], Dict, Dict]:
    """(plan_kind, anatomy, array_nbytes) for either device plan class (or
    a host-only/stateless term with no device plan)."""
    if plan is None:
        return None, {}, {}
    cls = type(plan).__name__
    if cls == "DBIndexPlan":
        real1 = int(index.block_members.size) if index is not None else None
        real2 = int(index.link_block.size) if index is not None else None
        pad1 = int(plan.pass1.gather_padded.numel())
        pad2 = int(plan.pass2.gather_padded.numel())
        anat = {
            "num_blocks": int(plan.num_blocks),
            "block_capacity": int(plan.block_capacity),
            "capacity_utilization": plan.num_blocks / plan.block_capacity,
            "pass1_rows_padded": pad1,
            "pass2_rows_padded": pad2,
            "pass1_tile_groups": int(plan.pass1.num_out_tiles),
            "pass2_tile_groups": int(plan.pass2.num_out_tiles),
            "tile": {"tm": int(plan.pass1.tm), "ts": int(plan.pass1.ts)},
            "ell": {
                "p1_width": (int(plan.p1_ell.shape[1])
                             if plan.p1_ell is not None else None),
                "p2_width": (int(plan.p2_ell.shape[1])
                             if plan.p2_ell is not None else None),
            },
        }
        if real1 is not None:
            anat["pass1_rows_real"] = real1
            anat["pass1_headroom_utilization"] = real1 / max(pad1, 1)
        if real2 is not None:
            anat["pass2_rows_real"] = real2
            anat["pass2_headroom_utilization"] = real2 / max(pad2, 1)
        return cls, anat, plan.array_nbytes()
    if cls == "IIndexPlan":
        real = int(index.wd_members.size) if index is not None else None
        pad = int(plan.wd_plan.gather_padded.numel())
        anat = {
            "max_level": int(plan.max_level),
            "wd_rows_padded": pad,
            "wd_tile_groups": int(plan.wd_plan.num_out_tiles),
            "tile": {"tm": int(plan.wd_plan.tm), "ts": int(plan.wd_plan.ts)},
            "chains": int(plan.forest.chains.count),
        }
        if real is not None:
            anat["wd_rows_real"] = real
            anat["wd_headroom_utilization"] = real / max(pad, 1)
        return cls, anat, plan.array_nbytes()
    if cls == "ShardedDBPlan":
        # array_nbytes: this rank's shard (what its device holds)
        anat = {
            "ndev": int(plan.ndev),
            "num_blocks": int(plan.num_blocks),
            "block_capacity": int(plan.block_capacity),
            "capacity_utilization": plan.num_blocks / plan.block_capacity,
            "rows1_per_shard": int(plan.rows1),
            "rows2_per_shard": int(plan.rows2),
            "has_ell": bool(plan.has_ell),
            "shard_balance": plan.shard_row_loads(),
            "patch_ledger": {
                k: plan.stats[k]
                for k in ("version", "patched_bytes_total", "rebuilds",
                          "full_bytes")
                if k in plan.stats
            },
        }
        return cls, anat, plan.array_nbytes()
    # unknown plan type: still account what we can
    nb = {}
    if hasattr(plan, "array_nbytes"):
        nb = plan.array_nbytes()
    return cls, {"type": cls}, nb


def _state_telemetry(session, term, kind) -> Dict:
    state = session._states.get((term, kind)) if kind else None
    if state is None:
        return {}
    out = {}
    pv = getattr(state, "plan_version", None)
    if pv is None and getattr(state, "plan", None) is not None:
        pv = getattr(state.plan, "stats", {}).get("version")
    if pv is not None:
        out["plan_version"] = int(pv)
    if hasattr(state, "reorg_count"):
        out["reorg_count"] = int(state.reorg_count)
    try:
        out["staleness"] = {k: float(v)
                            for k, v in state.staleness.items()}
    except Exception:
        pass
    return out


# ---------------------------------------------------------------------- #
def _match_groups(session, spec) -> List[int]:
    """Group indices selected by ``spec``: None → all; an int → that group;
    a QuerySpec / window spec → the groups serving it."""
    n = len(session.compiled.groups)
    if spec is None:
        return list(range(n))
    if isinstance(spec, int):
        if not 0 <= spec < n:
            raise IndexError(f"group {spec} out of range (have {n})")
        return [spec]
    from repro_torch.core.api import QuerySpec, as_window

    if isinstance(spec, QuerySpec):
        window, agg = spec.window, spec.agg
    else:
        window, agg = as_window(spec), None
    out = [
        gi for gi, grp in enumerate(session.compiled.groups)
        if grp.window == window and (agg is None or agg in grp.aggs)
    ]
    if not out:
        raise KeyError(f"no compiled group serves {spec!r}")
    return out


def explain_session(session, spec=None) -> PlanReport:
    """Build the :class:`PlanReport` for ``session`` (no execution).

    ``spec`` filters: ``None`` explains every compiled group; an ``int``
    selects one group by index; a :class:`QuerySpec` or window spec
    selects the group(s) serving that window.
    """
    from repro_torch.core.api import _kind_of, window_kind

    groups: List[GroupReport] = []
    total = 0
    for gi in _match_groups(session, spec):
        grp = session.compiled.groups[gi]
        kind = _kind_of(grp.engine)
        cap = session.registry.capability(grp.engine)
        terms: List[TermReport] = []
        gbytes = 0
        arts = session._group_artifacts(gi)
        for term, (index, plan) in zip(session._group_terms(gi), arts):
            ikind, ianat = _index_anatomy(index)
            pkind, panat, nb = _plan_anatomy(plan, index)
            pbytes = sum(nb.values())
            gbytes += pbytes
            terms.append(TermReport(
                window=term.name(),
                index_kind=ikind,
                index=ianat,
                plan_kind=pkind,
                plan=panat,
                array_nbytes=nb,
                plan_nbytes=pbytes,
                state=_state_telemetry(session, term, kind),
            ))
        groups.append(GroupReport(
            window=grp.window.name(),
            window_kind=window_kind(grp.window),
            attr=grp.attr,
            aggs=tuple(grp.aggs),
            engine=grp.engine,
            capability={
                "name": cap.name, "priority": cap.priority,
                "windows": list(cap.windows), "device": cap.device,
                "sharded": cap.sharded, "incremental": cap.incremental,
            },
            candidates=_candidate_rows(session, grp),
            lowering=_lowering_report(session, gi),
            terms=terms,
            group_nbytes=gbytes,
        ))
        total += gbytes
    g = session.graph
    return PlanReport(
        n_vertices=int(g.n),
        n_edges=int(np.asarray(g.src).size),
        version=int(session.version),
        sharded=bool(session._sharded),
        groups=groups,
        total_plan_nbytes=total,
    )

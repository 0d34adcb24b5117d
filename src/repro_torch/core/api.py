"""Unified window-analytics API: declarative specs, engine registry, Session.

The paper's GWQ abstraction (Definition 3) is one algebraic object —
``GWQ(G, W, Σ, A)`` — and this module gives it one API surface:

* :class:`QuerySpec` — a declarative value object naming (W, Σ, A).  The
  window may be any :class:`~repro_torch.core.windows.WindowExpr` — the two
  paper leaves (:class:`~repro_torch.core.windows.KHopWindow` /
  :class:`~repro_torch.core.windows.TopologicalWindow`, or shorthand
  ``("khop", 2)`` / ``"topological"``) or a composite expression
  (``Union`` / ``Intersect`` / ``Diff`` / ``Filter`` over direction-aware
  leaves).  Specs canonicalize their window, so algebraically equal
  queries (``Union(A, B)`` vs ``Union(B, A)``) hit one cached plan.

* **Window lowering** — two paths, chosen per (expression, monoid set) by
  the planner (:func:`plan_window_program`): the *generic* path evaluates
  the expression to per-vertex member sets (packed-bitset combinators) and
  feeds the unchanged DBIndex builder/plan pipeline; the *algebraic* fast
  path skips materialization where the algebra allows — idempotent monoids
  evaluate a ``Union`` as ``combine(result(A), result(B))`` over the
  children's existing materializations, and sum-monoid channels ride
  inclusion–exclusion (``Σ(A∪B) = Σ(A) + Σ(B) − Σ(A∩B)``) with only the
  (smaller) intersection materialized.
* :class:`EngineRegistry` — every backend declares an
  :class:`EngineCapability` (window kinds, aggregates, device / sharded /
  incremental flags) and the planner selects by capability; an
  :class:`UnsupportedQueryError` lists what *is* available when nothing
  matches.  The ``torch`` engine (the DBIndex device plan, kernels K1/K2)
  takes the reference's ``jax`` row, and ``torch-iindex`` (the I-Index
  device plan: K1, then the inheritance-scan kernel) its ``jax-iindex``
  row.
* :func:`compile_queries` — dedups windows across specs, groups by
  (window, attr, engine), and fuses all aggregates sharing a window into
  one multi-channel plan (k aggregates collapse to one gather feeding k
  stacked monoid segment-reduces).
* :class:`Session` — owns graph + indices + compiled device plans, routes
  :class:`~repro_torch.core.updates.UpdateBatch` streams through the
  incremental maintenance path (device plans survive updates via plan
  patching), and serves ``run`` / ``run_many`` traffic.  Device plans live
  on ``torch_device`` (the card unless the caller asks for the CPU).
* :class:`SessionView` — a read snapshot pinned at one version.  Device
  plans are patched in place, so :meth:`Session.update` first clones a
  plan that a live view holds (copy-on-write) and patches the clone: a
  view answers at its own version for as long as it lives.
* ``Session(g, specs, mesh=mesh)`` builds a
  :class:`~repro_torch.distributed.window_runtime.ShardedSession` over a
  ``torch.distributed`` device mesh, SPMD: the ``torch-sharded`` engine
  (priority 70), a plan shard on each rank's device.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs as _obs
from repro_torch.core import engine_torch as et
from repro_torch.core.aggregates import (
    AGGREGATES,
    ALL_REGISTERED,
    CHANNEL_AGG,
    register_aggregate,  # noqa: F401  (re-export: the open-registry API)
)
from repro_torch.core.graph import Graph
from repro_torch.core.windows import (
    Intersect,
    KHopWindow,
    TopologicalWindow,
    Union,
    WindowExpr,
    canonicalize,
    filter_attrs,
    window_kind_of,
)
from repro_torch.device import resolve_device

#: live view over the open aggregate registry — capabilities declared with
#: it serve aggregates registered *after* the engine was
ALL_AGGREGATES = ALL_REGISTERED

# ---------------------------------------------------------------------- #
#  Declarative specs
# ---------------------------------------------------------------------- #
def as_window(spec):
    """Normalize a window spec — a :class:`WindowExpr` (canonicalized),
    ``"topological"`` or ``("khop", k)`` shorthand."""
    if isinstance(spec, WindowExpr):
        return canonicalize(spec)
    if spec == "topological":
        return TopologicalWindow()
    if isinstance(spec, (tuple, list)) and len(spec) == 2 and spec[0] == "khop":
        return KHopWindow(int(spec[1]))
    raise TypeError(f"not a window spec: {spec!r}")


def window_kind(window) -> str:
    """Capability kind of a window: the two paper leaves keep their names;
    everything else — combinators, filters, direction-variant k-hop leaves
    — is ``"composite"`` and is served by the engines whose capability row
    declares it (the generic materialized lowering or, where the algebra
    allows, the fast path)."""
    return window_kind_of(window)


@dataclasses.dataclass(frozen=True)
class QuerySpec:
    """One graph window function (W, Σ, A) plus an optional engine hint.

    ``engine=None`` lets the planner pick by capability; naming an engine
    pins it (and fails loudly if the capability doesn't cover the query).
    """

    window: object
    agg: str = "sum"
    attr: str = "val"
    engine: Optional[str] = None

    def __post_init__(self):
        object.__setattr__(self, "window", as_window(self.window))
        if self.agg not in AGGREGATES:
            raise ValueError(f"unknown aggregate {self.agg!r} "
                             f"(have {sorted(AGGREGATES)})")


class UnsupportedQueryError(ValueError):
    """No registered engine capability covers the requested query."""


# ---------------------------------------------------------------------- #
#  Capability-based engine registry
# ---------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class EngineCapability:
    """What one backend can serve.  Selection is purely declarative."""

    name: str
    windows: Tuple[str, ...]  # of {"khop", "topological"}
    aggregates: frozenset
    device: bool = False  # runs on the torch data plane (the card)
    sharded: bool = False  # needs a device mesh across cards
    incremental: bool = False  # index survives UpdateBatches
    priority: int = 0  # higher wins among matches

    def covers(self, window, aggs: Sequence[str]) -> bool:
        return window_kind(window) in self.windows and set(aggs) <= self.aggregates


def _cap_row(c: "EngineCapability") -> str:
    """One self-explaining capability-table row (window kinds, aggregates,
    and the device/sharded/incremental flags) for planner error messages."""
    return (
        f"{c.name}: windows={c.windows}, aggs={sorted(c.aggregates)}, "
        f"device={c.device}, sharded={c.sharded}, incremental={c.incremental}"
    )


class EngineRegistry:
    """Backends register (capability, runner); the planner selects by need.

    A runner evaluates *all* aggregates of one window in a single call —
    ``runner(g, window, values, aggs, index=None, plan=None, **opts) ->
    {agg: ndarray}`` — so fused multi-channel execution is the interface,
    not an afterthought; host backends simply loop.
    """

    def __init__(self):
        self._caps: Dict[str, EngineCapability] = {}
        self._runners: Dict[str, object] = {}

    def register(self, cap: EngineCapability, runner) -> None:
        self._caps[cap.name] = cap
        self._runners[cap.name] = runner

    def capabilities(self) -> Tuple[EngineCapability, ...]:
        return tuple(self._caps.values())

    def capability(self, name: str) -> EngineCapability:
        if name not in self._caps:
            raise UnsupportedQueryError(
                f"unknown engine {name!r}; registered: {sorted(self._caps)}"
            )
        return self._caps[name]

    def select(
        self,
        window,
        aggs: Sequence[str],
        *,
        engine: Optional[str] = None,
        device: Optional[bool] = None,
        sharded: bool = False,
        incremental: Optional[bool] = None,
    ) -> str:
        """Pick an engine by capability; raise with the full table if none fit."""
        if engine is not None:
            cap = self.capability(engine)
            if not cap.covers(window, aggs):
                raise UnsupportedQueryError(
                    f"engine {engine!r} does not cover "
                    f"({window_kind(window)}, {sorted(set(aggs))}): it serves "
                    f"{_cap_row(cap)}"
                )
            return engine
        matches = [
            c for c in self._caps.values()
            if c.covers(window, aggs)
            and (device is None or c.device == device)
            and c.sharded == sharded
            and (incremental is None or c.incremental == incremental)
        ]
        if not matches:
            table = "; ".join(_cap_row(c) for c in self._caps.values())
            raise UnsupportedQueryError(
                f"no engine serves ({window_kind(window)}, {sorted(set(aggs))}, "
                f"device={device}, sharded={sharded}, "
                f"incremental={incremental}) — registered: {table}"
            )
        return max(matches, key=lambda c: c.priority).name

    def run(self, name: str, g: Graph, window, values, aggs: Sequence[str],
            index=None, plan=None, **opts) -> Dict[str, np.ndarray]:
        cap = self.capability(name)
        if not cap.covers(window, aggs):
            raise UnsupportedQueryError(
                f"engine {name!r} does not cover "
                f"({window_kind(window)}, {sorted(set(aggs))}): it serves "
                f"{_cap_row(cap)}"
            )
        unknown = set(opts) - KNOWN_OPTS
        if unknown:  # typos must fail loudly, not silently use defaults
            raise TypeError(
                f"unknown engine option(s) {sorted(unknown)}; "
                f"known: {sorted(KNOWN_OPTS)}"
            )
        return self._runners[name](g, window, np.asarray(values), tuple(aggs),
                                   index=index, plan=plan, **opts)



# every option any runner understands; EngineRegistry.run rejects the rest
KNOWN_OPTS = frozenset({
    "limit",  # nonindex
    "method", "num_hashes", "cluster_hops", "bfs_batch", "pair_budget",
    "seed",  # build_dbindex
    "iterations", "chunk_size",  # build_eagr
    "tm", "ts", "headroom", "schedule", "torch_device",  # device
    "mesh", "axis",  # sharded
})


def _pick(opts: dict, *names) -> dict:
    return {k: opts[k] for k in names if k in opts}


def recompile_count() -> int:
    """Distinct plan shape signatures the fused query executor has run in
    this process (:func:`repro_torch.core.engine_torch.signature_count`) —
    the port's analogue of the reference's jit cache entries, and the ONE
    number the zero-respecialization contract is asserted on."""
    return et.signature_count()


def record_recompiles(obs=None) -> int:
    """Publish :func:`recompile_count` as the ``repro_recompiles`` gauge
    (in ``obs`` or the process default registry); returns the count."""
    reg = obs if obs is not None else _obs.get_registry()
    n = recompile_count()
    reg.gauge("repro_recompiles",
              "distinct plan shape signatures run by the fused executor").set(n)
    return n


def _run_nonindex(g, window, values, aggs, index=None, plan=None, **opts):
    from repro_torch.core.nonindex import query_pervertex

    kw = _pick(opts, "limit")
    return {a: query_pervertex(g, window, values, a, **kw) for a in aggs}


def _run_bitset(g, window, values, aggs, index=None, plan=None, **opts):
    from repro_torch.core.nonindex import query_batched_bitset

    return {a: query_batched_bitset(g, window, values, a) for a in aggs}


def _build_dbindex(g, window, opts):
    from repro_torch.core.dbindex import build_dbindex

    kw = _pick(opts, "method", "num_hashes", "cluster_hops", "bfs_batch",
               "pair_budget", "seed")
    if isinstance(window, TopologicalWindow):
        kw.setdefault("method", "mc")
    return build_dbindex(g, window, **kw)


def _run_dbindex(g, window, values, aggs, index=None, plan=None, **opts):
    index = index if index is not None else _build_dbindex(g, window, opts)
    return {a: index.query(values, a) for a in aggs}


def _run_iindex(g, window, values, aggs, index=None, plan=None, **opts):
    from repro_torch.core.iindex import build_iindex

    index = index if index is not None else build_iindex(g)
    return {a: index.query(values, a) for a in aggs}


def _run_eagr(g, window, values, aggs, index=None, plan=None, **opts):
    from repro_torch.core.eagr import build_eagr

    if index is None:
        index = build_eagr(g, window, **_pick(opts, "iterations", "chunk_size"))
    return {a: index.query(values, a) for a in aggs}


def _run_torch_dbindex(g, window, values, aggs, index=None, plan=None, **opts):
    if plan is None:
        index = index if index is not None else _build_dbindex(g, window, opts)
        plan = et.plan_from_dbindex(
            index, **_pick(opts, "tm", "ts", "headroom", "torch_device"))
    outs = et.query_dbindex_multi(plan, values, tuple(aggs))
    return {a: o.cpu().numpy() for a, o in zip(aggs, outs)}


def _run_torch_iindex(g, window, values, aggs, index=None, plan=None, **opts):
    from repro_torch.core.iindex import build_iindex

    if plan is None:
        index = index if index is not None else build_iindex(g)
        plan = et.plan_from_iindex(index, **_pick(opts, "tm", "ts", "torch_device"))
    outs = et.query_iindex_multi(plan, values, tuple(aggs),
                                 **_pick(opts, "schedule"))
    return {a: o.cpu().numpy() for a, o in zip(aggs, outs)}


def _run_torch_sharded(g, window, values, aggs, index=None, plan=None, **opts):
    """Fused multi-aggregate query across a mesh, SPMD (every rank calls
    it).  ``plan`` may be a
    :class:`~repro_torch.distributed.window_runtime.ShardedDBPlan` (the
    streaming Session path: the shards are already on the ranks' devices)
    or a host :class:`~repro_torch.core.engine_torch.DBIndexPlan` (one-shot:
    sharded per call)."""
    from repro_torch.distributed import window_runtime as wr

    if isinstance(plan, wr.ShardedDBPlan):
        outs = wr.query_sharded_multi(plan, values, tuple(aggs))
        return {a: o.cpu().numpy() for a, o in zip(aggs, outs)}
    mesh = opts.get("mesh")
    if mesh is None:
        raise UnsupportedQueryError("engine 'torch-sharded' needs a mesh= opt")
    if plan is None:
        index = index if index is not None else _build_dbindex(g, window, opts)
        # the whole single-host plan stays on the CPU; each rank uploads
        # its own shard, to the card unless the caller names the CPU
        plan = et.plan_from_dbindex(index, **_pick(opts, "tm", "ts"),
                                    torch_device="cpu")
    outs = et.query_dbindex_sharded_multi(plan, values, tuple(aggs), mesh,
                                          axis=opts.get("axis", "data"),
                                          torch_device=opts.get("torch_device", "cuda"))
    return {a: o.cpu().numpy() for a, o in zip(aggs, outs)}


#: the fused [B, n] executor of each device engine (Session.run_many)
_FUSED_MANY = {"torch": et.query_dbindex_multi,
               "torch-iindex": et.query_iindex_multi}


def _default_registry() -> EngineRegistry:
    r = EngineRegistry()
    both = ("khop", "topological")
    # "composite" marks the engines that consume *materialized* window sets
    # (bitset algebra, DBIndex blocks and the device plans built from
    # them) — the generic WindowExpr lowering; per-vertex-BFS and
    # structure-specific backends (nonindex, eagr, iindex) stay leaf-only
    any_w = both + ("composite",)
    r.register(EngineCapability("nonindex", both, ALL_AGGREGATES, priority=0),
               _run_nonindex)
    r.register(EngineCapability("bitset", any_w, ALL_AGGREGATES, priority=10),
               _run_bitset)
    r.register(EngineCapability("eagr", both, ALL_AGGREGATES, priority=20),
               _run_eagr)
    r.register(EngineCapability("dbindex", any_w, ALL_AGGREGATES,
                                incremental=True, priority=30), _run_dbindex)
    r.register(EngineCapability("iindex", ("topological",), ALL_AGGREGATES,
                                incremental=True, priority=40), _run_iindex)
    r.register(EngineCapability("torch", any_w, ALL_AGGREGATES, device=True,
                                incremental=True, priority=50),
               _run_torch_dbindex)
    r.register(EngineCapability("torch-iindex", ("topological",), ALL_AGGREGATES,
                                device=True, incremental=True, priority=60),
               _run_torch_iindex)
    # the stacked-channel sharded executor serves every monoid aggregate
    # (sum channels ride one all_reduce(SUM) a pass, min/max MIN/MAX)
    r.register(EngineCapability("torch-sharded", any_w, ALL_AGGREGATES,
                                device=True, sharded=True, incremental=True,
                                priority=70), _run_torch_sharded)
    return r


DEFAULT_REGISTRY = _default_registry()

# ---------------------------------------------------------------------- #
#  Algebraic fast-path planner (per (expr, monoid) lowering choice)
# ---------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class WindowProgram:
    """Algebraic evaluation plan for one composite window.

    ``terms`` are the canonical sub-expressions that get materialized
    (index + plan each); the composite's monoid channels are reassembled
    from the terms' channel results: sum-monoid channels as
    ``Σ sum_coefs[t] · term[t]`` (inclusion–exclusion), idempotent channels
    as ``combine(term[t] for t in idem_terms)``.  ``term_aggs`` is the
    closed set of canonical channel aggregates requested from every term
    (one fused multi-channel query per term).
    """

    terms: Tuple[object, ...]
    term_aggs: Tuple[str, ...]
    sum_coefs: Tuple[int, ...]
    idem_terms: Tuple[int, ...]


def _group_channels(aggs: Sequence[str]) -> set:
    chans = set()
    for name in aggs:
        a = AGGREGATES[name]
        chans |= set(zip((m.name for m in a.monoids), a.channel_sources))
    return chans


def plan_window_program(window, aggs: Sequence[str]):
    """Fast-path plan for (window, aggs), or None → generic materialization.

    The choice is per (expression shape, monoid set): a ``Union`` whose
    aggregates are all idempotent (min/max) evaluates as a pointwise
    combine over the children's materializations (any arity); once a
    sum-monoid channel is involved, the union rides pairwise
    inclusion–exclusion (``Σ(A∪B) = Σ(A) + Σ(B) − Σ(A∩B)``) — the
    intersection is the only extra materialization and is never larger
    than either child.  Wider unions with sum channels, and every other
    combinator, take the generic path (still correct — just materialized).
    """
    if not isinstance(window, Union):
        return None
    channels = _group_channels(aggs)
    if any(ch not in CHANNEL_AGG for ch in channels):
        return None  # a channel with no canonical per-term aggregate
    kids = window.exprs
    has_sum = any(m == "sum" for m, _ in channels)
    if has_sum:
        if len(kids) != 2:
            return None  # inclusion–exclusion kept pairwise (2^n terms)
        terms = kids + (canonicalize(Intersect(*kids)),)
        coefs = (1, 1, -1)
    else:
        terms = kids
        coefs = (1,) * len(kids)
    term_aggs = tuple(sorted({CHANNEL_AGG[ch] for ch in channels}))
    return WindowProgram(terms=terms, term_aggs=term_aggs, sum_coefs=coefs,
                         idem_terms=tuple(range(len(kids))))


def _combine_program(prog: WindowProgram, aggs: Sequence[str], term_outs):
    """Reassemble the composite's channels from per-term results and
    finalize.  Pure pointwise arithmetic (works on [n] vectors and [B, n]
    batches alike); exact — hence bit-identical to direct set evaluation —
    on integer-valued attributes, and dtype-preserving on the int paths
    (coefficients are ±1, so no float upcast sneaks in)."""
    outs, chan_cache = {}, {}
    for name in aggs:
        a = AGGREGATES[name]
        chans = []
        for m, src in zip(a.monoids, a.channel_sources):
            key = (m.name, src)
            if key not in chan_cache:
                ca = CHANNEL_AGG[key]
                if m.name == "sum":
                    acc = None
                    for coef, out in zip(prog.sum_coefs, term_outs):
                        v = np.asarray(out[ca])
                        v = v if coef == 1 else v * coef
                        acc = v if acc is None else acc + v
                else:
                    acc = np.asarray(term_outs[prog.idem_terms[0]][ca])
                    for t in prog.idem_terms[1:]:
                        acc = m.np_op(acc, np.asarray(term_outs[t][ca]))
                chan_cache[key] = acc
            chans.append(chan_cache[key])
        outs[name] = a.finalize_np(*chans)
    return outs


# ---------------------------------------------------------------------- #
#  Multi-query compiler
# ---------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class PlanGroup:
    """All aggregates that share one (window, attr, engine) — one fused plan."""

    window: object
    attr: str
    engine: str
    aggs: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class CompiledQueries:
    """Output of :func:`compile_queries`: fused groups + spec back-pointers."""

    specs: Tuple[QuerySpec, ...]
    groups: Tuple[PlanGroup, ...]
    spec_slots: Tuple[Tuple[int, int], ...]  # spec i -> (group, agg position)

    def results_for_specs(self, group_results: Sequence[Dict[str, np.ndarray]]):
        return [
            group_results[gi][self.groups[gi].aggs[ai]]
            for gi, ai in self.spec_slots
        ]


def compile_queries(
    specs: Sequence[QuerySpec],
    *,
    registry: EngineRegistry = None,
    device: Optional[bool] = None,
    sharded: bool = False,
) -> CompiledQueries:
    """Plan a batch of queries: dedup windows, select engines by capability,
    fuse aggregates sharing a (window, attr, engine) into one group."""
    registry = registry or DEFAULT_REGISTRY
    specs = tuple(
        s if isinstance(s, QuerySpec) else QuerySpec(*s) for s in specs
    )
    # first pass: resolve each spec's engine (explicit pin or union-capability
    # selection over every spec sharing the window — so sum+min on one window
    # land on an engine that can fuse both)
    union: Dict[Tuple[object, str], set] = {}
    for s in specs:
        if s.engine is None:
            union.setdefault((s.window, s.attr), set()).add(s.agg)
    chosen: Dict[Tuple[object, str], str] = {
        key: registry.select(key[0], sorted(aggs), device=device, sharded=sharded)
        for key, aggs in union.items()
    }
    # second pass: group by (window, attr, engine), dedup aggregates in order
    order: List[Tuple[object, str, str]] = []
    agg_lists: Dict[Tuple[object, str, str], List[str]] = {}
    slots: List[Tuple[int, int]] = []
    for s in specs:
        engine = s.engine or chosen[(s.window, s.attr)]
        if s.engine is not None:  # validate explicit pins eagerly
            registry.select(s.window, (s.agg,), engine=engine)
        key = (s.window, s.attr, engine)
        if key not in agg_lists:
            agg_lists[key] = []
            order.append(key)
        if s.agg not in agg_lists[key]:
            agg_lists[key].append(s.agg)
        slots.append((order.index(key), agg_lists[key].index(s.agg)))
    groups = tuple(
        PlanGroup(window=w, attr=attr, engine=e, aggs=tuple(agg_lists[(w, attr, e)]))
        for (w, attr, e) in order
    )
    return CompiledQueries(specs=specs, groups=groups, spec_slots=tuple(slots))


# ---------------------------------------------------------------------- #
#  Session: graph + indices + compiled plans under streamed updates
# ---------------------------------------------------------------------- #
_DBINDEX_ENGINES = {"dbindex", "torch", "torch-sharded"}
_IINDEX_ENGINES = {"iindex", "torch-iindex"}


def _kind_of(engine: str) -> Optional[str]:
    """Index kind behind an engine name, or None for stateless backends."""
    if engine in _DBINDEX_ENGINES:
        return "dbindex"
    if engine in _IINDEX_ENGINES:
        return "iindex"
    return None


class Session:
    """Stateful serving facade over compiled window queries.

    Builds one index (and, for device engines, one device plan) per distinct
    window — shared by every query group on that window — then keeps all of
    it fresh under :meth:`update` via the incremental maintenance path
    (batched index update + tile-group plan patching + staleness policy), so
    device plans survive a stream of ``UpdateBatch``es with unchanged
    shapes.

    ``torch_device`` places every device plan and the device BFS; it
    defaults to the card and raises when CUDA is absent unless the caller
    passes ``"cpu"``.  ``device`` keeps the reference's meaning: it selects
    host or device engines in :func:`compile_queries`.

    Device plans are patched in place.  The session tracks its live
    :class:`SessionView` objects, and :meth:`update` patches a clone of any plan
    one of them holds (copy-on-write: ``plan_clones`` / ``plan_clone_bytes``
    count them), so a pinned view keeps its version's plan; with no live
    view the patch stays in place.  :meth:`snapshot` and :meth:`update`
    serialize on one lock, so no view is taken of a half-patched state.

    Passing ``mesh=`` (a ``torch.distributed`` ``DeviceMesh``; ``axis``
    names its data dimension or dimensions) constructs a
    :class:`~repro_torch.distributed.window_runtime.ShardedSession`
    instead: query planning selects sharded capabilities, plans live as
    per-rank device shards, and streamed updates write only changed tile
    groups into the shard owning them.
    """

    #: subclasses flip this to make compile_queries select sharded engines
    _sharded = False

    def __new__(cls, g=None, specs=None, **kw):
        if cls is Session and kw.get("mesh") is not None:
            from repro_torch.distributed.window_runtime import ShardedSession

            return super().__new__(ShardedSession)
        return super().__new__(cls)

    def __init__(
        self,
        g: Graph,
        specs: Sequence[QuerySpec],
        *,
        registry: EngineRegistry = None,
        device: Optional[bool] = None,
        policy=None,
        method: str = "emc",
        tm: int = 512,
        ts: int = 512,
        plan_headroom: float = 0.5,
        compact_garbage: Optional[float] = None,
        mesh=None,
        axis="data",
        use_device_bfs: Optional[bool] = None,
        obs=None,
        tracer=None,
        torch_device="cuda",
    ):
        self.torch_device = resolve_device(torch_device)
        self.registry = registry or DEFAULT_REGISTRY
        self.obs = obs if obs is not None else _obs.get_registry()
        self.tracer = tracer if tracer is not None else _obs.get_tracer()
        self._m_updates = self.obs.counter(
            "repro_session_updates_total", "UpdateBatches applied")
        self._m_snapshots = self.obs.counter(
            "repro_snapshots_total", "SessionView captures")
        self._m_clones = self.obs.counter(
            "repro_plan_clones_total",
            "device plans cloned before a patch because a live view held them")
        self.compiled = compile_queries(specs, registry=self.registry,
                                        device=device, sharded=self._sharded)
        self.graph = g
        self.mesh = mesh
        self._opts = dict(tm=tm, ts=ts, method=method,
                          torch_device=self.torch_device, mesh=mesh, axis=axis)
        self._state_cfg = dict(
            method=method, policy=policy, tm=tm, ts=ts,
            plan_headroom=plan_headroom, compact_garbage=compact_garbage,
            axis=axis, use_device_bfs=use_device_bfs,
        )
        self.updates_applied = 0
        #: monotonically increasing state version: bumped once per
        #: :meth:`update`.  Snapshots pin it; the serving layer's result
        #: cache is keyed by it.
        self.version = 0
        self._result_cache = None
        #: live views (filled by :meth:`snapshot`): a plan one of them
        #: holds is cloned before :meth:`update` patches it
        self._views: "weakref.WeakSet[SessionView]" = weakref.WeakSet()
        self._lock = threading.RLock()
        self.plan_clones = 0
        self.plan_clone_bytes = 0
        # per-group lowering programs: composite windows on stateful
        # dbindex-backed engines may decompose algebraically (their *terms*
        # get materialized instead of the composite itself)
        self._programs: Tuple[Optional[WindowProgram], ...] = tuple(
            plan_window_program(grp.window, grp.aggs)
            if (_kind_of(grp.engine) == "dbindex"
                and window_kind(grp.window) == "composite")
            else None
            for grp in self.compiled.groups
        )
        # one stateful engine per (materialized window, index kind) — shared
        # by every group (and every program term) on that key, so the
        # device/sharded flags are the OR over the sharing groups (a host
        # group must not strip the plan a device group compiled).  EAGR
        # indices are rebuilt lazily after updates (no incremental story).
        self._states: Dict[Tuple[object, str], object] = {}
        self._eagr: Dict[object, object] = {}
        self._eagr_dirty = False
        need_device: Dict[Tuple[object, str], bool] = {}
        need_shard: Dict[Tuple[object, str], bool] = {}
        for gi, grp in enumerate(self.compiled.groups):
            kind = _kind_of(grp.engine)
            if kind is None:
                continue
            cap = self.registry.capability(grp.engine)
            for term in self._group_terms(gi):
                key = (term, kind)
                need_device[key] = need_device.get(key, False) or cap.device
                need_shard[key] = need_shard.get(key, False) or cap.sharded
        for (window, kind), dev in need_device.items():
            self._states[(window, kind)] = self._make_state(
                window, kind, dev, need_shard[(window, kind)])

    def _make_state(self, window, kind: str, device: bool, sharded: bool = False):
        """The per-(window, kind) streaming state.  The base Session always
        builds single-device engines; :class:`ShardedSession` overrides
        this to place sharded windows on the mesh.

        ``compact_garbage=None`` defers to the engine's own default: the
        single-host compaction re-lays pass 1 (a shape change), so it waits
        as long as a rebuild (0.5); the sharded one is in place and
        shape-stable, so it fires earlier (0.25)."""
        from repro_torch.core.streaming import StreamingEngine

        cfg = self._state_cfg
        cg = cfg["compact_garbage"]
        return StreamingEngine(
            self.graph, window, index_kind=kind, method=cfg["method"],
            policy=cfg["policy"], device=device, tm=cfg["tm"], ts=cfg["ts"],
            plan_headroom=cfg["plan_headroom"],
            compact_garbage=0.5 if cg is None else cg,
            use_device_bfs=cfg["use_device_bfs"],
            obs=self.obs, tracer=self.tracer, torch_device=self.torch_device,
        )

    # ------------------------------------------------------------------ #
    def _group_terms(self, gi: int) -> Tuple[object, ...]:
        """Windows materialized for group ``gi``: the program's terms on
        the algebraic fast path, else the group window itself."""
        prog = self._programs[gi]
        return prog.terms if prog is not None else (
            self.compiled.groups[gi].window,)

    def _group_artifacts(self, gi: int) -> Tuple[Tuple[object, object], ...]:
        """Per-term (index, plan) pairs of group ``gi``."""
        grp = self.compiled.groups[gi]
        kind = _kind_of(grp.engine)
        out = []
        for term in self._group_terms(gi):
            state = self._states.get((term, kind)) if kind else None
            if state is not None:
                out.append((state.index, state.plan))
            elif grp.engine == "eagr":
                if self._eagr_dirty:
                    self._eagr.clear()
                    self._eagr_dirty = False
                if term not in self._eagr:
                    from repro_torch.core.eagr import build_eagr

                    self._eagr[term] = build_eagr(self.graph, term)
                out.append((self._eagr[term], None))
            else:
                out.append((None, None))
        return tuple(out)

    def _values_for(self, grp: PlanGroup, values, graph=None):
        if values is None:
            return (self.graph if graph is None else graph).attrs[grp.attr]
        if isinstance(values, dict):
            return values[grp.attr]
        return values

    # ------------------------------------------------------------------ #
    #  Group executors — shared by Session.run/run_many and SessionView
    # ------------------------------------------------------------------ #
    def _exec_term(self, grp: PlanGroup, window, index, plan, values, g,
                   aggs):
        with self.tracer.span("query.term", cat="query",
                              engine=grp.engine, window=window.name()):
            return self.registry.run(
                grp.engine, g, window, values, aggs,
                index=index, plan=plan, **self._opts,
            )

    def _exec_term_many(self, grp: PlanGroup, window, index, plan, vb, g,
                        aggs):
        """One [B, n] batch through one materialized window.

        A device plan takes the whole batch in one fused query: the batch
        rides the channel columns, so each pass is one K1 launch (and the
        I-Index's inheritance scan one scan launch).  Host engines loop the
        batch.
        """
        with self.tracer.span("query.term", cat="query", engine=grp.engine,
                              window=window.name(), rows=len(vb)):
            if plan is not None and grp.engine in _FUSED_MANY:
                outs = _FUSED_MANY[grp.engine](plan, vb, tuple(aggs))
                return {a: o.cpu().numpy() for a, o in zip(aggs, outs)}
            rows = [
                self.registry.run(grp.engine, g, window, v, aggs,
                                  index=index, plan=plan, **self._opts)
                for v in vb
            ]
            return {a: np.stack([r[a] for r in rows]) for a in aggs}

    def _exec_group(self, gi: int, arts, values, graph=None):
        grp = self.compiled.groups[gi]
        g = self.graph if graph is None else graph
        vals = self._values_for(grp, values, graph=g)
        prog = self._programs[gi]
        if prog is None:
            index, plan = arts[0]
            return self._exec_term(grp, grp.window, index, plan, vals, g,
                                   grp.aggs)
        term_outs = [
            self._exec_term(grp, term, index, plan, vals, g, prog.term_aggs)
            for term, (index, plan) in zip(prog.terms, arts)
        ]
        return _combine_program(prog, grp.aggs, term_outs)

    def _exec_group_many(self, gi: int, arts, vb, graph=None):
        grp = self.compiled.groups[gi]
        g = self.graph if graph is None else graph
        prog = self._programs[gi]
        if prog is None:
            index, plan = arts[0]
            return self._exec_term_many(grp, grp.window, index, plan, vb, g,
                                        grp.aggs)
        term_outs = [
            self._exec_term_many(grp, term, index, plan, vb, g,
                                 prog.term_aggs)
            for term, (index, plan) in zip(prog.terms, arts)
        ]
        return _combine_program(prog, grp.aggs, term_outs)

    def _run_view_group(self, view: "SessionView", gi: int, values):
        """Group ``gi`` at ``view``'s version: the executor a view calls (a
        :class:`~repro_torch.distributed.window_runtime.ShardedSession`
        that leads its followers replicates the call first)."""
        return self._exec_group(gi, view.artifacts[gi], values, graph=view.graph)

    def _run_view_group_many(self, view: "SessionView", gi: int, vb):
        return self._exec_group_many(gi, view.artifacts[gi], vb, graph=view.graph)

    # ------------------------------------------------------------------ #
    def snapshot(self) -> "SessionView":
        """Pin the current version for reads (see :class:`SessionView`).

        Waits for an :meth:`update` in progress on another thread, so the
        view is a point-in-time state; while it lives, updates patch clones
        of the plans it holds."""
        self._m_snapshots.inc()
        with self._lock:
            view = SessionView(
                session=self,
                graph=self.graph,
                version=self.version,
                artifacts=tuple(self._group_artifacts(gi)
                                for gi in range(len(self.compiled.groups))),
            )
            self._views.add(view)
        return view

    def attach_cache(self, cache) -> None:
        """Attach an affected-owner result cache (duck-typed; see
        :class:`repro_torch.serve.window_service.AffectedOwnerCache`):
        ``run`` consults it for current-attribute reads, and every
        :meth:`update` feeds it the per-group affected-owner sets so it
        invalidates only the vertices whose windows actually changed.

        One session serves one cache: a second distinct cache raises —
        front one Session with one caching service (or ``use_cache=False``)."""
        if self._result_cache is not None and self._result_cache is not cache:
            raise RuntimeError(
                "a result cache is already attached to this Session; "
                "detach it (session._result_cache = None) or construct the "
                "second WindowService with use_cache=False"
            )
        self._result_cache = cache
        cache.bind(self)

    def group_state_keys(self, gi: int) -> Tuple[str, ...]:
        """Report keys of the stateful engines behind group ``gi`` (the
        keys of :meth:`update` reports / :attr:`staleness`) — one per
        materialized term on the algebraic fast path, empty for groups
        with no incremental state (their cached results cannot be bounded
        by an affected set and must be dropped wholesale on update)."""
        grp = self.compiled.groups[gi]
        kind = _kind_of(grp.engine)
        if kind is None:
            return ()
        return tuple(
            f"{term.name()}/{kind}" for term in self._group_terms(gi)
            if (term, kind) in self._states
        )

    def run(self, values=None) -> List[np.ndarray]:
        """Evaluate every compiled spec; returns results in spec order.

        ``values`` overrides the graph attribute(s): an array (applied to
        every group) or a dict keyed by attr name.  With an attached result
        cache and ``values=None``, group vectors come from / land in the
        cache (see :meth:`attach_cache`).
        """
        return self.snapshot().run(values)

    def run_many(self, values_batch) -> List[np.ndarray]:
        """Serving-style traffic: evaluate all specs for a [B, n] batch of
        attribute vectors in one fused query per device group."""
        return self.snapshot().run_many(values_batch)

    # ------------------------------------------------------------------ #
    #  EXPLAIN / ANALYZE (repro_torch.obs.explain / repro_torch.obs.profile)
    # ------------------------------------------------------------------ #
    def explain(self, spec=None):
        """EXPLAIN: the compiled plan as a structured
        :class:`~repro_torch.obs.explain.PlanReport` — engine resolution
        with rejected candidates, per-(expr, monoid set) lowering choice,
        plan anatomy and exact per-array device footprint — without
        executing anything.  ``spec`` optionally narrows to one group (an
        index, a :class:`QuerySpec`, or a window spec)."""
        from repro_torch.obs.explain import explain_session

        return explain_session(self, spec)

    def analyze(self, spec=None, values=None):
        """ANALYZE: execute the selected groups once under a
        phase-profiled scope and return an
        :class:`~repro_torch.obs.profile.AnalyzeReport` attributing wall
        time to named phases around the port's launches (host prep, K1's
        pass 1 and pass 2 or its window-difference pass, the inheritance
        scan, finalize, host combine), with each group's results.  It
        launches the fused executors' own kernels but records no plan
        signature, so it never moves :func:`recompile_count`."""
        from repro_torch.obs.profile import analyze_session

        return analyze_session(self, spec, values=values)

    # ------------------------------------------------------------------ #
    def digest(self, include_results: bool = False) -> Dict:
        """Per-version content digest (crc32 over graph + plan arrays,
        optionally the result vectors) — the leader/follower self-check
        channel; see :func:`repro_torch.obs.audit.session_digest`."""
        from repro_torch.obs.audit import session_digest

        with self._lock:  # not across a concurrent update's half-patched state
            return session_digest(self, include_results=include_results)

    # ------------------------------------------------------------------ #
    def update(self, batch) -> Dict:
        """Stream one UpdateBatch through every stateful index + plan.

        The graph edit is applied once and shared by every engine (their
        index maintenance is per-window, the graph is not).  Bumps
        :attr:`version`; each report carries the new version, the engine's
        ``affected_owners`` array and ``plan_clone_bytes`` (non-zero when a
        live view held the plan, which was cloned before the patch), and
        an attached result cache is invalidated for exactly those owners.

        Attribute-value edits skip index and plan maintenance (both are
        structure-only) and invalidate the result cache through the
        DBIndex reverse link map: exactly the owners whose windows contain
        an edited vertex.  The exception is a
        :class:`~repro_torch.core.windows.Filter` predicate attribute,
        whose states the streaming engines re-filter or rebuild.
        """
        with self.tracer.span("session.update", cat="update",
                              size=batch.size, version=self.version + 1):
            with self._lock:
                return self._update_inner(batch)

    def _held_plans(self) -> set:
        """ids of the plans the live views hold."""
        return {id(plan) for view in list(self._views)
                for arts in view.artifacts for _, plan in arts
                if plan is not None}

    def _update_inner(self, batch) -> Dict:
        from repro_torch.core.updates import apply_batch

        g2 = apply_batch(self.graph, batch)
        held = self._held_plans()
        reports = {}
        for (window, kind), eng in self._states.items():
            key = f"{window.name()}/{kind}"
            clone_bytes = 0
            if eng.plan is not None and id(eng.plan) in held:
                # copy-on-write: a live view reads this plan, so the patch
                # goes into a clone (same shapes, fresh storage)
                with self.tracer.span("plan.clone", cat="update", state=key):
                    eng.plan = eng.plan.clone()
                clone_bytes = eng.plan.plan_nbytes()
                self.plan_clones += 1
                self.plan_clone_bytes += clone_bytes
                self._m_clones.inc()
            with self.tracer.span("maintain", cat="update", state=key):
                reports[key] = eng.apply(batch, graph=g2)
            reports[key]["plan_clone_bytes"] = clone_bytes
        self.graph = g2
        self._eagr_dirty = (
            bool(self._eagr) and batch.size > 0) or self._eagr_dirty
        self.updates_applied += 1
        self.version += 1
        self._m_updates.inc()
        for rep in reports.values():
            rep["version"] = self.version
        if self._result_cache is not None:
            with self.tracer.span("cache.invalidate", cat="update"):
                self._invalidate_cache(batch, g2, reports)
        return reports

    def _invalidate_cache(self, batch, g2, reports) -> None:
        """Feed the attached result cache each group's affected owners
        (None: drop the group's entry wholesale)."""
        from repro_torch.core.updates import containing_owners

        edited: Dict[str, list] = {}
        for e in batch.attr_edits:
            edited.setdefault(e.name, []).append(e.vertices)
        owner_map = {}
        for gi, grp in enumerate(self.compiled.groups):
            keys = self.group_state_keys(gi)
            group_attr_touched = grp.attr in edited
            if not keys:
                # no incremental state to bound the blast radius: drop on
                # any change that could affect the group, keep on a
                # provably-unrelated attr-only batch
                unrelated = (
                    batch.size == 0 and not group_attr_touched
                    and not (set(edited) & set(filter_attrs(grp.window))))
                owner_map[gi] = np.empty(0, np.int32) if unrelated else None
                continue
            parts = [reports[k]["affected_owners"] for k in keys]
            if group_attr_touched:
                verts = np.unique(np.concatenate(edited[grp.attr]))
                kind = _kind_of(grp.engine)
                for term in self._group_terms(gi):
                    state = self._states.get((term, kind))
                    if state is not None:
                        parts.append(containing_owners(
                            state.index, g2, term, verts))
            owner_map[gi] = np.unique(np.concatenate(parts)).astype(
                np.int32) if parts else np.empty(0, np.int32)
        self._result_cache.on_update(self.version, owner_map)

    def replay(self, batches) -> int:
        """Replay an ordered batch stream through :meth:`update`.

        ``batches`` yields :class:`~repro_torch.core.updates.UpdateBatch`es
        or ``(version, batch)`` pairs (the WAL record shape — versions are
        informational here; :attr:`version` advances once per batch).
        Returns the number of batches applied.
        """
        applied = 0
        for item in batches:
            self.update(item[1] if isinstance(item, tuple) else item)
            applied += 1
        return applied

    def save_checkpoint(self, directory) -> Tuple[int, str]:
        """Write a snapshot checkpoint of this session's graph + digest to
        ``directory`` (:mod:`repro_torch.serve.checkpoint`); returns
        ``(version, path)``.  Pair with ``restore_from_wal(...,
        checkpoint=directory)`` for bounded-tail recovery."""
        from repro_torch.serve.checkpoint import save_checkpoint

        return save_checkpoint(self, directory)

    @classmethod
    def from_checkpoint(cls, path, specs, **kw) -> "Session":
        """Rebuild a session from one checkpoint file (no WAL tail).

        The checkpoint's section CRCs and stamped ``graph_crc`` are
        verified on load; the restored session resumes version numbering
        at the checkpoint version.  Every engine state is a deterministic
        function of the graph, so the results are bitwise the writer's —
        but a freshly built plan's bytes may differ from the writer's
        patched ones, so digest checks against it skip the plan component
        (``check_plans=False``).  ``kw`` goes to the constructor
        (``torch_device`` among them)."""
        from repro_torch.serve.checkpoint import load_checkpoint

        version, graph, _digest = load_checkpoint(path)
        session = cls(graph, specs, **kw)
        session.version = int(version)
        return session

    @classmethod
    def restore_from_wal(cls, g: Graph, specs, wal, *,
                         upto_version: Optional[int] = None,
                         checkpoint=None, **kw):
        """Crash recovery: rebuild a session by replaying a write-ahead log.

        ``g`` and ``specs`` must be the *base* graph and specs the crashed
        session started from (the WAL records every batch applied since);
        ``wal`` is a log file path, a WAL segment directory, an open
        :class:`~repro_torch.serve.wal.WriteAheadLog` /
        :class:`~repro_torch.serve.wal.SegmentedWriteAheadLog`, or any
        iterable of ``(version, batch)`` pairs.  ``upto_version`` stops the
        replay early (point-in-time recovery).

        ``checkpoint`` names a checkpoint directory (or a single checkpoint
        file): recovery then starts from the newest usable checkpoint at or
        below ``upto_version`` and replays only the WAL *tail* past it —
        ``g`` is ignored in that case (the checkpoint carries the graph).
        With no usable checkpoint, recovery falls back to the full replay.
        All other kwargs go to the constructor (``torch_device`` among
        them) — they must match the crashed session's for bitwise results.
        """
        session = None
        after_version = 0
        if checkpoint is not None:
            from repro_torch.serve.checkpoint import latest_checkpoint

            ckpt_path = os.fspath(checkpoint)
            if os.path.isdir(ckpt_path):
                found = latest_checkpoint(ckpt_path, upto_version=upto_version)
                ckpt_path = found[1] if found else None
            if ckpt_path is not None:
                session = cls.from_checkpoint(ckpt_path, specs, **kw)
                after_version = session.version
        if hasattr(wal, "replay"):
            records = list(wal.replay())
        elif isinstance(wal, (str, os.PathLike)) and os.path.isdir(wal):
            from repro_torch.serve.wal import read_segmented_records

            records = read_segmented_records(wal, after_version)
        elif isinstance(wal, (str, os.PathLike)):
            from repro_torch.serve.wal import read_wal_records

            records = read_wal_records(wal)[0]
        else:
            records = list(wal)
        if session is None:
            session = cls(g, specs, **kw)
        for item in records:
            version, batch = item if isinstance(item, tuple) else (None, item)
            if version is not None and version <= after_version:
                continue  # below the checkpoint: already folded in
            if upto_version is not None and version is not None \
                    and version > upto_version:
                break
            session.update(batch)
        return session

    @property
    def staleness(self) -> Dict[str, Dict]:
        """Per-state sharing-loss telemetry (same keys as :meth:`update`
        reports) plus each engine's reorganize count."""
        return {
            f"{window.name()}/{kind}": {**eng.staleness,
                                        "reorg_count": eng.reorg_count}
            for (window, kind), eng in self._states.items()
        }


# ---------------------------------------------------------------------- #
#  SessionView: version-pinned read snapshot
# ---------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True, eq=False)
class SessionView:
    """A read view of a :class:`Session` pinned at one version.

    Holds the graph and every group's (index, plan) by reference.  Graphs
    and host indices are immutable; device plans are patched in place by
    :meth:`Session.update`, which therefore clones a plan a live view
    holds and patches the clone (copy-on-write), so the view answers at
    its own version for as long as it lives.  The serving layer
    (:class:`repro_torch.serve.window_service.WindowService`) keeps one
    active view for readers and republishes on ``flip()``.

    Cache interplay: current-attribute reads (``values=None``) consult the
    session's attached result cache.  Cache reads and writes are gated on
    the view's version matching the cache's — a view pinned behind the
    write head bypasses the cache rather than polluting it.  Views compare
    by identity (the session tracks the live ones in a weak set).
    """

    session: Session
    graph: Graph
    version: int
    #: per group: per materialized term, an (index, plan) pair — generic
    #: groups hold one term, algebraic fast-path groups one per program term
    artifacts: Tuple[Tuple[Tuple[object, object], ...], ...]

    def run_group(self, gi: int, values=None) -> Dict[str, np.ndarray]:
        """All aggregates of plan group ``gi`` (one fused query per
        materialized term on device engines), cache-aware for
        current-attribute reads."""
        cache = self.session._result_cache
        if values is None and cache is not None:
            hit = cache.get_group(gi, self.version)
            if hit is not None:
                return hit
        with self.session.tracer.span("query.group", cat="query", group=gi,
                                      version=self.version):
            out = self.session._run_view_group(self, gi, values)
        if values is None and cache is not None:
            cache.put_group(gi, self.version, out)
        return out

    def run_group_many(self, gi: int, values_batch) -> Dict[str, np.ndarray]:
        """[B, n] batch through plan group ``gi`` — one fused query per
        materialized term on device engines (the scheduler's coalesced
        flush path)."""
        with self.session.tracer.span("query.group", cat="query", group=gi,
                                      version=self.version, batched=True):
            return self.session._run_view_group_many(self, gi, values_batch)

    def run(self, values=None) -> List[np.ndarray]:
        groups = range(len(self.session.compiled.groups))
        return self.session.compiled.results_for_specs(
            [self.run_group(gi, values) for gi in groups]
        )

    def run_many(self, values_batch) -> List[np.ndarray]:
        vb = np.asarray(values_batch)
        if vb.ndim != 2:
            raise ValueError("values_batch must be [B, n]")
        groups = range(len(self.session.compiled.groups))
        return self.session.compiled.results_for_specs(
            [self.run_group_many(gi, vb) for gi in groups]
        )

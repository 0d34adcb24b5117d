"""Streaming dynamic-update engine (paper §4.3 Phase 1 + Phase 2 policy).

Ties the batched maintenance path into one stateful object:

    engine = StreamingEngine(g, KHopWindow(2))
    for batch in stream:                # UpdateBatch per tick
        engine.apply(batch)             # graph + index + device plan, all
        ans = engine.query("sum")       #   maintained incrementally

Each ``apply`` is: vectorized graph edit → batched index maintenance (one
multi-source BFS for the whole batch) → incremental device-plan patch
(only the tile groups whose blocks / owner links / WD segments changed).

Phase 2 (reorganization) is driven by :class:`StalenessPolicy`: the merged
index after phase-1 updates is exact but *less shared* — links and garbage
blocks accumulate.  When sharing loss crosses the configured ratio, the
engine rebuilds from scratch and re-baselines.  The I-Index maintenance is
a localized exact rebuild (no sharing loss), so the policy only arms for
DBIndex engines.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np

from repro_torch import obs as _obs
from repro_torch.core import engine_torch as et
from repro_torch.core.dbindex import DBIndex, build_dbindex
from repro_torch.core.graph import Graph
from repro_torch.core.iindex import build_iindex
from repro_torch.core.updates import (
    UpdateBatch,
    apply_batch,
    update_dbindex_batch,
    update_iindex_batch,
)
from repro_torch.core.windows import KHopWindow, TopologicalWindow, filter_attrs
from repro_torch.device import resolve_device


def garbage_block_fraction(index) -> float:
    """Zero-link block fraction (see :meth:`DBIndex.garbage_block_fraction`);
    tolerates duck-typed policy test doubles that only carry
    ``num_blocks``/``link_block``/``stats`` (unbound calls keep the metric
    definition in one place)."""
    if getattr(index, "link_block", None) is None:
        return 0.0
    # zero-block guard here as well as in the method: a duck-typed index
    # reaching the unbound call must not divide by num_blocks == 0 (a graph
    # whose edges — or whose filtered windows — were all deleted)
    if not getattr(index, "num_blocks", 0):
        return 0.0
    return DBIndex.garbage_block_fraction(index, DBIndex.linked_blocks_mask(index))


@dataclasses.dataclass(frozen=True)
class StalenessPolicy:
    """Reorganize when phase-1 sharing loss exceeds a threshold.

    ``max_link_ratio``: rebuild when ``num_links`` exceeds this multiple of
    the last full build's link count (links are the pass-2 work and the
    paper's sharing metric).  ``max_block_ratio``: same for block count
    (appended secondary + garbage blocks).  ``max_garbage_ratio``: rebuild
    when the zero-link (garbage) block fraction crosses this — the signal
    for delete-dominated streams, which *shrink* links and so never trip
    the growth ratios.  ``min_batches`` delays the first check so bursts
    amortize.
    """

    max_link_ratio: float = 1.5
    max_block_ratio: float = 2.0
    max_garbage_ratio: float = 0.5
    min_batches: int = 1

    def should_reorganize(
        self, index: DBIndex, base_links: int, base_blocks: int, batches_since: int
    ) -> bool:
        if batches_since < self.min_batches:
            return False
        if not index.num_blocks:
            # an empty index (every edge — or every filtered window —
            # deleted) has nothing to reorganize; without this guard the
            # block-ratio test against a max(base, 1) baseline can trip
            # forever on a drained graph, rebuilding an empty index each tick
            return False
        links = int(index.stats.get("num_links", 0))
        return (
            links > self.max_link_ratio * max(base_links, 1)
            or index.num_blocks > self.max_block_ratio * max(base_blocks, 1)
            or garbage_block_fraction(index) > self.max_garbage_ratio
        )


def _flipped_vertices(g_old: Graph, g_new: Graph, batch: UpdateBatch,
                      touched) -> np.ndarray:
    """Edited vertices whose *truthiness* changed for any touched
    predicate attribute.  Edits that keep truthiness (e.g. ``1 → 2``) do
    not move window membership — ``Filter`` tests ``pred != 0`` — so they
    need no index maintenance at all."""
    flipped = []
    for name in touched:
        verts = np.unique(np.concatenate(
            [e.vertices for e in batch.attr_edits if e.name == name]
        ))
        old = np.asarray(g_old.attrs[name])[verts] != 0
        new = np.asarray(g_new.attrs[name])[verts] != 0
        flipped.append(verts[old != new])
    if not flipped:
        return np.empty(0, np.int64)
    return np.unique(np.concatenate(flipped)).astype(np.int64)


def _filter_flip_owners(index, g_new: Graph, window,
                        flipped: np.ndarray) -> np.ndarray:
    """Exact affected-owner set of a predicate truthiness flip.

    Combinators are pointwise per-owner set operations (k-hop/topological
    expansion exists only at the leaves, *below* every Filter), so a flip
    at ``u`` can only change ``u``'s own membership in any ``W(v)``.  The
    owners whose windows change are therefore exactly covered by

        {v : u ∈ W_old(v)}  ∪  {v : u ∈ W_new(v)}    for flipped u

    The old side is the DBIndex reverse link map
    (:meth:`~repro_torch.core.dbindex.DBIndex.owners_of_members` — the flipped
    members' blocks' owners).  The new side only matters for *gained*
    members (falsy → truthy) or a :class:`~repro_torch.core.windows.Diff`
    subtrahend (where a loss below adds members above); every window
    expression is otherwise monotone in its predicates, so a loss-only
    flip satisfies ``W_new(v) ⊆ W_old(v)`` and the reverse map alone is
    exact.  The new side, when needed, is one reverse-direction bitset
    sweep on the updated graph
    (:func:`~repro_torch.core.windows.expr_containing_owners`).
    """
    from repro_torch.core.windows import expr_containing_owners, has_diff

    owners = np.asarray(index.owners_of_members(flipped), np.int64)
    gains = np.any(np.asarray(
        [g_new.attrs[a][flipped] != 0 for a in filter_attrs(window)]
    )) if flipped.size else False
    if gains or has_diff(window):
        new_side = expr_containing_owners(g_new, window, flipped)
        owners = np.union1d(owners, np.asarray(new_side, np.int64))
    return owners.astype(np.int32)


def _attr_only_report(engine, batch, g2: Graph, t0: float) -> Optional[Dict]:
    """Shared attr-edit handling for the streaming engines (single-host and
    sharded).  Returns None when normal structural maintenance should run.

    A pure attribute-value batch (``size == 0``) skips index/plan
    maintenance entirely — both indices are structure-only, so swapping in
    the attr-updated graph is the whole update.  The exception is a batch
    editing a :class:`Filter` predicate attribute: membership may change
    for the flipped vertices, so the engine re-filters exactly the owners
    whose windows can change (``engine._refilter``), falling back to a
    full rebuild only when the flip reaches more than half the owners or
    the batch also carries structural edits.
    """
    touched = set(batch.edited_attrs()) & set(filter_attrs(engine.window))
    if batch.size > 0 and not touched:
        return None
    refiltered = False
    reorganized = False
    changed = np.empty(0, np.int32)
    if touched and batch.size > 0:
        # mixed structural + predicate batch: membership moves for both
        # reasons at once — rebuild outright rather than composing bounds
        engine.graph = g2
        engine._build()
        changed = np.arange(g2.n, dtype=np.int32)
        reorganized = True
    elif touched:
        flipped = _flipped_vertices(engine.graph, g2, batch, touched)
        refilter = getattr(engine, "_refilter", None)
        if flipped.size == 0:
            engine.graph = g2  # truthiness unchanged: structure unchanged
        else:
            owners = _filter_flip_owners(engine.index, g2, engine.window,
                                         flipped)
            engine.graph = g2
            if refilter is None or owners.size > g2.n // 2:
                engine._build()
                changed = np.arange(g2.n, dtype=np.int32)
                reorganized = True
            else:
                reorganized = refilter(owners)
                changed = (np.arange(g2.n, dtype=np.int32) if reorganized
                           else owners)
                refiltered = not reorganized
    else:
        engine.graph = g2
    plan_version = getattr(engine, "plan_version", None)
    if plan_version is None:
        plan_version = int(engine.plan.stats.get("version", 0))
    m = getattr(engine, "_m_maint", None)
    if m is not None:  # duck-typed engines without obs instruments skip
        action = ("reorganize" if reorganized
                  else "refilter" if refiltered else "attr_only")
        m.labels(engine.index_kind, action).inc()
    return {
        "batch_size": batch.size,
        "attr_edits": int(batch.attr_size),
        "affected": int(changed.size),
        "affected_owners": changed,
        "plan_version": int(plan_version),
        "t_index_s": time.perf_counter() - t0,
        "t_plan_s": 0.0,
        "reorganized": reorganized,
        "refiltered": refiltered,
    }


class StreamingEngine:
    """Stateful graph + index + device plan under a stream of UpdateBatches.

    ``index_kind``: "dbindex" (k-hop or topological windows) or "iindex"
    (topological only: the I-Index plan, K1 + the inheritance-scan
    kernel).  ``device=False`` keeps
    everything host-side (NumPy query executor) — useful for oracles.
    ``torch_device`` places the device plan and the device BFS; it defaults
    to the card and raises when CUDA is absent unless it names the CPU.
    """

    #: extra attributes of the ``index.update`` trace span
    _span_tags: Dict = {}

    def __init__(
        self,
        g: Graph,
        window,
        *,
        index_kind: str = "dbindex",
        method: str = "emc",
        policy: Optional[StalenessPolicy] = None,
        device: bool = True,
        tm: int = 512,
        ts: int = 512,
        plan_headroom: float = 0.0,
        compact_garbage: float = 0.5,
        use_device_bfs: Optional[bool] = None,
        obs=None,
        tracer=None,
        torch_device="cuda",
    ):
        assert index_kind in ("dbindex", "iindex")
        self.torch_device = resolve_device(torch_device)
        self.obs = obs if obs is not None else _obs.get_registry()
        self.tracer = tracer if tracer is not None else _obs.get_tracer()
        self._m_maint = self.obs.counter(
            "repro_maintenance_total",
            "maintenance outcomes per applied batch",
            labels=("kind", "action"))
        self._m_t_index = self.obs.histogram(
            "repro_index_update_seconds", "batched index maintenance time",
            labels=("kind",))
        self._m_t_plan = self.obs.histogram(
            "repro_plan_patch_seconds", "device plan patch/rebuild time",
            labels=("kind",))
        if index_kind == "iindex":
            assert isinstance(window, TopologicalWindow), "I-Index is topological-only"
        if isinstance(window, TopologicalWindow) and method == "emc":
            method = "mc"  # EMC is k-hop only (paper §4.2.2)
        self.graph = g
        self.window = window
        self.index_kind = index_kind
        self.method = method
        self.policy = policy or StalenessPolicy()
        self.device = device
        self.tm, self.ts = tm, ts
        self.plan_headroom = plan_headroom
        self.compact_garbage = compact_garbage
        # pins the affected-owner BFS routing (None = size-based auto
        # between host NumPy and the bitset_expand kernel)
        self.use_device_bfs = use_device_bfs
        self.batches_applied = 0
        self.edits_applied = 0
        self.reorg_count = 0
        self.batches_since_reorg = 0
        #: monotonically increasing plan version: every patch or rebuild of
        #: the device plan bumps it, so a reader can tell whether the plan
        #: object it pinned is still the engine's newest one
        self.plan_version = 0
        self._build(initial=True)

    # ------------------------------------------------------------------ #
    def _build(self, initial: bool = False) -> None:
        if self.index_kind == "dbindex":
            self.index: object = build_dbindex(self.graph, self.window, method=self.method)
            self._base_links = int(self.index.stats.get("num_links", 0))
            self._base_blocks = int(self.index.num_blocks)
        else:
            self.index = build_iindex(self.graph)
            self._base_links = self._base_blocks = 0
        self.plan = self._new_plan() if self.device else None
        self.batches_since_reorg = 0
        if not initial:
            self.reorg_count += 1
            self.plan_version += 1

    # ------------------------------------------------------------------ #
    #  The plan steps a sharded state lays out differently
    #  (repro_torch.distributed.window_runtime.ShardedStreamState)
    # ------------------------------------------------------------------ #
    def _new_plan(self):
        """A fresh device plan of ``self.index`` (``self.plan`` is still
        the previous one, or None at the first build)."""
        if self.index_kind == "dbindex":
            return et.plan_from_dbindex(self.index, self.tm, self.ts,
                                        headroom=self.plan_headroom,
                                        torch_device=self.torch_device)
        return et.plan_from_iindex(self.index, self.tm, self.ts,
                                   torch_device=self.torch_device)

    def _patch_plan(self, index, owners: np.ndarray):
        """``self.plan`` with ``owners``' windows of ``index`` written in."""
        if self.index_kind == "dbindex":
            return et.patch_plan_dbindex(self.plan, index, owners,
                                         compact_garbage=self.compact_garbage,
                                         headroom=self.plan_headroom)
        return et.patch_plan_iindex(self.plan, index, owners)

    def _update_index(self, g2: Graph, batch: UpdateBatch):
        """The index after ``batch`` (``g2`` the updated graph), the owners
        whose windows changed, and the report's extra keys."""
        if self.index_kind == "dbindex":
            idx2, changed = update_dbindex_batch(
                self.index, g2, self.window, batch,
                use_device=self.use_device_bfs, torch_device=self.torch_device)
        else:
            idx2, changed = update_iindex_batch(self.index, g2, batch)
        return idx2, changed, {}

    def _finish_report(self, rep: Dict, extra: Optional[Dict]) -> Dict:
        """``apply``'s report, given the extra keys of ``_update_index``
        (None for an attribute-only batch)."""
        return rep

    # ------------------------------------------------------------------ #
    def _refilter(self, owners: np.ndarray) -> bool:
        """Re-evaluate exactly ``owners``'s windows after a predicate
        truthiness flip and phase-1-merge them into the index (the flip
        analogue of a structural batch: drop the owners' links, append
        secondary blocks over their re-filtered windows, patch only the
        touched tile groups).  Returns True when the merge tripped the
        staleness policy and the engine reorganized instead."""
        from repro_torch.core.updates import _merge_affected
        from repro_torch.core.windows import expr_windows

        wins = expr_windows(self.graph, self.window, owners)
        self.index = _merge_affected(self.index, owners, wins)
        self.batches_applied += 1
        self.batches_since_reorg += 1
        if self.policy.should_reorganize(
            self.index, self._base_links, self._base_blocks,
            self.batches_since_reorg,
        ):
            self._build()
            return True
        if self.device:
            self.plan = self._patch_plan(self.index, owners)
        self.plan_version += 1
        return False

    # ------------------------------------------------------------------ #
    def apply(self, batch: UpdateBatch, graph: Optional[Graph] = None) -> Dict:
        """Apply one batch; returns a timing/size report.

        ``graph`` optionally supplies the already-updated graph (``batch``
        applied to the current one) so a caller driving several engines —
        e.g. a :class:`repro_torch.core.api.Session` with states on multiple
        windows — pays for ``apply_batch`` once, not once per engine.
        """
        t0 = time.perf_counter()
        g2 = apply_batch(self.graph, batch) if graph is None else graph
        fast = _attr_only_report(self, batch, g2, t0)
        if fast is not None:
            return self._finish_report(fast, None)
        with self.tracer.span("index.update", cat="update",
                              kind=self.index_kind, size=batch.size,
                              **self._span_tags):
            idx2, changed, extra = self._update_index(g2, batch)
        self.graph, self.index = g2, idx2
        t_index = time.perf_counter() - t0
        self._m_t_index.labels(self.index_kind).observe(t_index)
        self.batches_applied += 1
        self.batches_since_reorg += 1
        self.edits_applied += batch.size

        reorganized = False
        if self.index_kind == "dbindex" and idx2.stats.get("last_full_rebuild"):
            # the updater rebuilt outright (affected set > n/2): the index is
            # as fresh as a phase-2 pass, so re-baseline the staleness policy
            self._base_links = int(idx2.stats.get("num_links", 0))
            self._base_blocks = int(idx2.num_blocks)
            self.batches_since_reorg = 0
        t1 = time.perf_counter()
        if self.index_kind == "dbindex" and self.policy.should_reorganize(
            idx2, self._base_links, self._base_blocks, self.batches_since_reorg
        ):
            with self.tracer.span("plan.patch", cat="update",
                                  kind=self.index_kind, action="reorganize"):
                self._build()
            reorganized = True
        elif self.device:
            with self.tracer.span("plan.patch", cat="update",
                                  kind=self.index_kind, action="patch"):
                self.plan = self._patch_plan(idx2, changed)
            self.plan_version += 1
        else:
            self.plan_version += 1  # host "plan" is the index itself
        t_plan = time.perf_counter() - t1
        self._m_t_plan.labels(self.index_kind).observe(t_plan)
        self._m_maint.labels(
            self.index_kind, "reorganize" if reorganized else "patch").inc()
        return self._finish_report({
            "batch_size": batch.size,
            "affected": int(np.asarray(changed).size),
            # the exact owner set whose windows were recomputed — the
            # serving layer's cache invalidates precisely these vertices
            "affected_owners": np.asarray(changed, np.int32),
            "plan_version": self.plan_version,
            "t_index_s": t_index,
            "t_plan_s": t_plan,
            "reorganized": reorganized,
            # device footprint after this batch: constant between reorgs
            # (headroom absorbs appends shape-stably) — EXPLAIN's stability
            # tests and the out-of-core accounting both key off this
            "plan_bytes": (int(self.plan.plan_nbytes())
                           if self.plan is not None
                           and hasattr(self.plan, "plan_nbytes") else 0),
        }, extra)

    # ------------------------------------------------------------------ #
    def query(self, agg: str = "sum", values=None) -> np.ndarray:
        """One aggregate, from the device plan (or the host index when the
        engine is host-only)."""
        if values is None:
            values = self.graph.attrs["val"]
        if not self.device:
            return self.index.query(np.asarray(values), agg)
        query = et.query_dbindex if self.index_kind == "dbindex" else et.query_iindex
        return query(self.plan, values, agg).cpu().numpy()

    def query_multi(self, aggs, values=None, **kw) -> list:
        """All ``aggs`` over the engine's window as one fused multi-channel
        plan (one gather feeding stacked per-monoid segment reduces)."""
        from repro_torch.core.api import DEFAULT_REGISTRY

        if values is None:
            values = self.graph.attrs["val"]
        engine = (
            ("torch" if self.index_kind == "dbindex" else "torch-iindex")
            if self.device
            else ("dbindex" if self.index_kind == "dbindex" else "iindex")
        )
        out = DEFAULT_REGISTRY.run(
            engine, self.graph, self.window, values, tuple(aggs),
            index=self.index, plan=self.plan, **kw,
        )
        return [np.asarray(out[a]) for a in aggs]

    # ------------------------------------------------------------------ #
    @property
    def staleness(self) -> Dict:
        """Sharing-loss telemetry for the phase-2 policy."""
        if self.index_kind != "dbindex":
            return {"link_ratio": 1.0, "block_ratio": 1.0, "garbage_ratio": 0.0}
        return {
            "link_ratio": int(self.index.stats.get("num_links", 0))
            / max(self._base_links, 1),
            "block_ratio": self.index.num_blocks / max(self._base_blocks, 1),
            "garbage_ratio": garbage_block_fraction(self.index),
        }

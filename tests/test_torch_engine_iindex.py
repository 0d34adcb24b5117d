"""The topological window on the port's device I-Index engine, port vs
reference, on the CPU.

The reference runs its ``jax-iindex`` engine with ``use_pallas=False``; the
port runs ``torch-iindex`` with ``torch_device="cpu"``, where K1 and the
inheritance scan take their plain versions.  Integer-valued attributes make
every float32 partial exact, so every aggregate agrees bit for bit whatever
the order of the adds; normal-valued attributes agree to rtol = atol = 1e-5
(K1 sums in another order than ``jnp``).  The DAG batches are made with
numpy, every insert from a lower topological rank to a higher one.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.core.api as r_api  # noqa: E402
from repro.core import engine_jax as ej  # noqa: E402
from repro.core import iindex as r_iindex  # noqa: E402
from repro.core import streaming as r_stream  # noqa: E402
from repro.core import updates as r_updates  # noqa: E402
from repro.graphs import generators as r_gen  # noqa: E402

import repro_torch.core.api as p_api  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import engine_torch as et  # noqa: E402
from repro_torch.core import iindex as p_iindex  # noqa: E402
from repro_torch.core import streaming as p_stream  # noqa: E402
from repro_torch.core import updates as p_updates  # noqa: E402
from repro_torch.graphs import generators as p_gen  # noqa: E402
from repro_torch.kernels.inherit_scan.ops import chain_layout, level_layout  # noqa: E402

AGGS = ("sum", "count", "avg", "min", "max", "var", "l2")
TILE_FIELDS = ("gather_padded", "seg_tiles", "m2out", "first_visit",
               "num_segments", "num_out_tiles", "tm", "ts")


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def plan_fields(plan) -> dict:
    """The fields both packages' I-Index plans hold."""
    out = {"n": plan.n, "max_level": int(plan.max_level),
           "pid": _np(plan.pid), "level": _np(plan.level)}
    for f in TILE_FIELDS:
        v = getattr(plan.wd_plan, f)
        out[f"wd_plan.{f}"] = v if isinstance(v, int) else _np(v)
    return out


def assert_same_plan(port_plan, ref_plan, index):
    a, b = plan_fields(port_plan), plan_fields(ref_plan)
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k
    # the port's own arrays: the level and chain layouts and the WD sizes
    order, ptr = level_layout(b["level"])
    assert np.array_equal(_np(port_plan.forest.order), order)
    assert np.array_equal(_np(port_plan.forest.level_ptr), ptr)
    chains = chain_layout(b["pid"], b["level"])
    assert port_plan.forest.chains.count == chains.count
    for got, want in zip(port_plan.forest.chains[:3], chains[:3]):
        assert got.dtype == torch.int32 and np.array_equal(_np(got), want)
    assert np.array_equal(_np(port_plan.wd_sizes), np.diff(index.wd_offsets).astype(np.float32))


def _graphs(n, seed=1, integer=True):
    rg = r_gen.with_random_attrs(r_gen.random_dag(n, 4.0, seed=seed, locality=40), seed=2)
    pg = p_gen.with_random_attrs(p_gen.random_dag(n, 4.0, seed=seed, locality=40), seed=2)
    if not integer:
        vals = np.random.default_rng(4).normal(size=n)
        rg, pg = rg.with_attr("val", vals), pg.with_attr("val", vals)
    return rg, pg


def _pair(n=300, aggs=AGGS, integer=True):
    rg, pg = _graphs(n, integer=integer)
    rs = r_api.Session(rg, [r_api.QuerySpec(r_api.TopologicalWindow(), a) for a in aggs],
                       use_pallas=False)
    ps = p_api.Session(pg, [p_api.QuerySpec(p_api.TopologicalWindow(), a) for a in aggs],
                       torch_device="cpu")
    return rs, ps


def _state(sess):
    (state,) = sess._states.values()
    return state


def dag_batch(g, rng, ins, dels, tail=None):
    """``ins`` inserts from a lower topological rank to a higher one and
    ``dels`` deletes of existing edges, as (src, dst, op) arrays; with
    ``tail``, every edge's head lies among the last ``tail`` share of the
    ranks (small descendant cones), else anywhere."""
    order = g.topological_order()
    rank = np.empty(g.n, np.int64)
    rank[order] = np.arange(g.n)
    lo_rank = int(g.n * (1 - tail)) if tail else 1
    heads = order[rng.integers(lo_rank, g.n, ins * 8)]
    srcs = order[(rng.random(ins * 8) * rank[heads]).astype(np.int64)]
    ok = (rank[srcs] < rank[heads]) & ~g.contains_edges(srcs, heads)
    _, first = np.unique(g.edge_keys(srcs, heads), return_index=True)
    pick = np.intersect1d(np.flatnonzero(ok), first)[:ins]
    cand = np.flatnonzero(rank[g.dst] >= lo_rank) if tail else np.arange(g.n_edges)
    e = rng.choice(cand, min(dels, cand.size), replace=False)
    return (np.concatenate([srcs[pick], g.src[e]]).astype(np.int32),
            np.concatenate([heads[pick], g.dst[e]]).astype(np.int32),
            np.concatenate([np.ones(pick.size, np.int8), -np.ones(e.size, np.int8)]))


def test_topological_session_selects_torch_iindex():
    rs, ps = _pair(120, aggs=("sum", "min"))
    assert [g.engine for g in rs.compiled.groups] == ["jax-iindex"]
    assert [g.engine for g in ps.compiled.groups] == ["torch-iindex"]
    assert isinstance(_state(ps).plan, et.IIndexPlan)


@pytest.mark.parametrize("integer", [True, False])
def test_run_and_run_many_match_reference(integer):
    rs, ps = _pair(300, integer=integer)
    assert_same_plan(_state(ps).plan, _state(rs).plan, _state(rs).index)
    vb = np.random.default_rng(5).integers(0, 100, (4, 300)).astype(np.float64)
    if not integer:
        vb = np.random.default_rng(5).normal(size=(4, 300))
    for got, ref in ((ps.run(), rs.run()), (ps.run_many(vb), rs.run_many(vb))):
        for a, x, y in zip(AGGS, got, ref):
            assert x.dtype == y.dtype == np.float32 and x.shape == y.shape, a
            if integer:
                assert np.array_equal(x, y), a
            else:
                np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-5, err_msg=a)
    many = ps.run_many(vb)
    for b in range(4):  # a batch row is the unbatched query, bit for bit
        for x, y in zip(many, ps.run(vb[b])):
            assert np.array_equal(x[b], y)


def test_run_is_one_k1_and_one_scan_call(monkeypatch):
    """Every channel of run() and run_many() rides one K1 call and one scan
    call: sum columns first, then min, then max (count skips K1)."""
    from repro_torch.kernels.inherit_scan import ops as scan_ops
    from repro_torch.kernels.segment_reduce import ops as k1_ops

    _, ps = _pair(200, aggs=("sum", "count", "avg", "min", "max"))
    k1_calls, scans = [], []
    k1, scan = k1_ops.segment_reduce_tiled, scan_ops.inherit_scan

    def counted_k1(values, *args, monoids, **kw):
        k1_calls.append((values.shape[1], tuple(monoids)))
        return k1(values, *args, monoids=monoids, **kw)

    def counted_scan(wdp, *args, monoids, **kw):
        scans.append((wdp.shape[1], tuple(monoids)))
        return scan(wdp, *args, monoids=monoids, **kw)

    monkeypatch.setattr(k1_ops, "segment_reduce_tiled", counted_k1)
    monkeypatch.setattr(scan_ops, "inherit_scan", counted_scan)
    ps.run()
    ps.run_many(np.random.default_rng(5).integers(0, 100, (8, 200)).astype(np.float64))
    assert k1_calls == [(3, (1, 1, 1)), (24, (8, 8, 8))]
    assert scans == [(4, (2, 1, 1)), (32, (16, 8, 8))]


def test_stream_matches_reference_every_version():
    """20+ DAG batches: tail batches (small cones, the patch path) and
    random ones (one of which trips the cone > n/2 rebuild).  After every
    batch the plans are array-equal, run/run_many bit for bit, and the
    port's signature count grows only when the reference's wd_plan shapes
    change."""
    rs, ps = _pair(300)
    vb = np.random.default_rng(6).integers(0, 100, (3, 300)).astype(np.float64)
    ps.run()
    ps.run_many(vb)
    rng = np.random.default_rng(13)
    shapes = (tuple(_state(rs).plan.wd_plan.seg_tiles.shape),)
    rebuilt, patched = 0, 0
    for i in range(22):
        s, d, op = dag_batch(ps.graph, rng, 6, 2, tail=None if i % 7 == 3 else 0.1)
        count0 = p_api.recompile_count()
        rrep = rs.update(r_updates.UpdateBatch(s, d, op))
        prep = ps.update(p_updates.UpdateBatch(s, d, op))
        for key in rrep:
            assert np.array_equal(rrep[key]["affected_owners"], prep[key]["affected_owners"])
        affected = int(prep["topological/iindex"]["affected"])
        rebuilt += affected == 300
        patched += affected < 300
        assert_same_plan(_state(ps).plan, _state(rs).plan, _state(rs).index)
        for got, ref in ((ps.run(), rs.run()), (ps.run_many(vb), rs.run_many(vb))):
            for a, x, y in zip(AGGS, got, ref):
                assert np.array_equal(x, y), (i, a)
        now = (tuple(_state(rs).plan.wd_plan.seg_tiles.shape),)
        if now == shapes:
            assert p_api.recompile_count() == count0, i
        shapes = now
    assert ps.version == rs.version == 22
    assert rebuilt >= 1 and patched >= 15


def test_streaming_engine_device_iindex_matches_reference():
    rg, pg = _graphs(250)
    rw, pw = r_api.TopologicalWindow(), p_api.TopologicalWindow()
    re = r_stream.StreamingEngine(rg, rw, index_kind="iindex", device=True, use_pallas=False)
    pe = p_stream.StreamingEngine(pg, pw, index_kind="iindex", device=True,
                                  torch_device="cpu")
    assert isinstance(pe.plan, et.IIndexPlan)
    rng = np.random.default_rng(3)
    for i in range(3):
        s, d, op = dag_batch(pe.graph, rng, 5, 2, tail=0.1)
        re.apply(r_updates.UpdateBatch(s, d, op))
        pe.apply(p_updates.UpdateBatch(s, d, op))
        for a in ("sum", "min", "avg"):
            assert np.array_equal(pe.query(a), re.query(a)), (i, a)
        for x, y in zip(pe.query_multi(AGGS), re.query_multi(AGGS)):
            assert np.array_equal(x, y), i


@pytest.mark.parametrize("schedule", ["level", "doubling"])
def test_registry_runs_both_schedules(schedule):
    rg, pg = _graphs(200)
    vals = rg.attrs["val"]
    ref = r_api.DEFAULT_REGISTRY.run("jax-iindex", rg, r_api.TopologicalWindow(), vals,
                                     AGGS, schedule=schedule, use_pallas=False)
    got = p_api.DEFAULT_REGISTRY.run("torch-iindex", pg, p_api.TopologicalWindow(), vals,
                                     AGGS, schedule=schedule, torch_device="cpu")
    for a in AGGS:
        assert got[a].dtype == ref[a].dtype and np.array_equal(got[a], ref[a]), a


def test_query_on_carried_plan_matches_reference():
    rs, _ = _pair(300)
    ridx, rplan = _state(rs).index, _state(rs).plan
    idx = convert.iindex_from_arrays({"n": ridx.n, "stats": ridx.stats,
                                      **{f: getattr(ridx, f) for f in convert.IINDEX_FIELDS}})
    assert_same_plan(et.plan_from_iindex(idx, torch_device="cpu"), rplan, ridx)
    plan = convert.iindex_plan_from_arrays(plan_fields(rplan), torch_device="cpu")
    assert_same_plan(plan, rplan, ridx)
    vals = rs.graph.attrs["val"]
    for schedule in ("level", "doubling"):
        got = et.query_iindex_multi(plan, vals, AGGS, schedule)
        ref = ej.query_iindex_multi(rplan, vals, AGGS, schedule=schedule, use_pallas=False)
        for a, x, y in zip(AGGS, got, ref):
            assert np.array_equal(x.numpy(), np.asarray(y)), (schedule, a)
    assert np.array_equal(et.query_iindex(plan, vals).numpy(),
                          np.asarray(ej.query_iindex(rplan, vals, use_pallas=False)))


def test_patched_plan_equals_fresh_plan_after_rebuild():
    """A batch whose cone covers more than half the vertices rebuilds the
    index outright; the patched plan then still equals the reference's."""
    rg, pg = _graphs(300)
    ridx, pidx = r_iindex.build_iindex(rg), p_iindex.build_iindex(pg)
    rplan = ej.plan_from_iindex(ridx)
    pplan = et.plan_from_iindex(pidx, torch_device="cpu")
    order = pg.topological_order()
    s, d = order[:3].astype(np.int32), order[3:6].astype(np.int32)  # early heads
    ok = ~pg.contains_edges(s, d)
    batch = (s[ok], d[ok], np.ones(int(ok.sum()), np.int8))
    rg2 = r_updates.apply_batch(rg, r_updates.UpdateBatch(*batch))
    pg2 = p_updates.apply_batch(pg, p_updates.UpdateBatch(*batch))
    ridx2, rch = r_updates.update_iindex_batch(ridx, rg2, r_updates.UpdateBatch(*batch))
    pidx2, pch = p_updates.update_iindex_batch(pidx, pg2, p_updates.UpdateBatch(*batch))
    assert pch.size == 300 and np.array_equal(rch, pch)  # the rebuild path
    rplan2 = ej.patch_plan_iindex(rplan, ridx2, rch)
    live = pplan.pid
    pplan2 = et.patch_plan_iindex(pplan, pidx2, pch)
    assert pplan2.pid is live  # the [n] arrays are written in place
    assert_same_plan(pplan2, rplan2, ridx2)


def test_patched_chain_layout_equals_fresh_plan_every_batch():
    """The chain layout that ``patch_plan_iindex`` writes in place after
    each batch of a DAG stream (tail and random batches) equals a fresh
    ``plan_from_iindex``'s, and never changes the plan's shapes."""
    _, ps = _pair(300, aggs=("sum", "max"))
    state = _state(ps)
    live = state.plan.forest.chains.vertices
    signature = state.plan.shape_signature()
    rng = np.random.default_rng(21)
    for i in range(22):
        s, d, op = dag_batch(ps.graph, rng, 6, 2, tail=None if i % 7 == 3 else 0.1)
        ps.update(p_updates.UpdateBatch(s, d, op))
        got, fresh = state.plan, et.plan_from_iindex(state.index, torch_device="cpu")
        assert got.forest.chains.vertices is live
        assert got.forest.chains.count == fresh.forest.chains.count
        for a, b in zip(got.forest.chains[:3], fresh.forest.chains[:3]):
            assert np.array_equal(_np(a), _np(b)), i
        assert got.shape_signature()[2:] == signature[2:]  # all but wd_plan's

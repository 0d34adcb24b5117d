"""The k-hop DBIndex ``Session`` end to end, port vs reference, on the CPU.

Integer-valued attributes (the generators draw integers in [0, 100)) make
every float32 partial sum exact, so ``sum``/``count``/``min``/``max``/
``avg`` agree bit for bit whatever the order of the adds; normal-valued
attributes agree to rtol = atol = 1e-5 (the order of the float32 adds
differs between the port's kernel and the reference's one-hot matmul).
The reference runs its Pallas kernels in interpret mode.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.core.api as r_api  # noqa: E402
from repro.core import engine_jax as ej  # noqa: E402
from repro.core import updates as r_updates  # noqa: E402
from repro.core import windows as r_win  # noqa: E402
from repro.graphs import generators as r_gen  # noqa: E402

import repro_torch.core.api as p_api  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import engine_torch as et  # noqa: E402
from repro_torch.core import updates as p_updates  # noqa: E402
from repro_torch.core import windows as p_win  # noqa: E402
from repro_torch.graphs import generators as p_gen  # noqa: E402

AGGS = ("sum", "count", "avg", "min", "max")
TILE_FIELDS = ("gather_padded", "seg_tiles", "m2out", "first_visit",
               "num_segments", "num_out_tiles", "tm", "ts")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return None if x is None else np.asarray(x)


def plan_fields(plan) -> dict:
    """Every array and static int of a DBIndex plan, either package's."""
    out = {"n": plan.n, "num_blocks": int(plan.num_blocks),
           "block_capacity": plan.block_capacity}
    for name in ("block_sizes", "link_counts", "p1_ell", "p2_ell"):
        out[name] = _np(getattr(plan, name))
    for p in ("pass1", "pass2"):
        tp = getattr(plan, p)
        for f in TILE_FIELDS:
            v = getattr(tp, f)
            out[f"{p}.{f}"] = v if isinstance(v, int) else _np(v)
    return out


def assert_same_fields(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        if a[k] is None or b[k] is None:
            assert a[k] is None and b[k] is None, k
        elif isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


GRAPHS = {
    "er300": lambda gen: gen.erdos_renyi(300, 6.0, seed=1),
    "er2000": lambda gen: gen.erdos_renyi(2000, 6.0, seed=3),
    "ba400_no_ell": lambda gen: gen.barabasi_albert(400, 2, seed=7),
}


def _pair(name, k, integer=True, **kw):
    rg = r_gen.with_random_attrs(GRAPHS[name](r_gen), seed=2)
    pg = p_gen.with_random_attrs(GRAPHS[name](p_gen), seed=2)
    if not integer:
        vals = np.random.default_rng(4).normal(size=pg.n)
        rg, pg = rg.with_attr("val", vals), pg.with_attr("val", vals)
    rs = r_api.Session(rg, [r_api.QuerySpec(r_api.KHopWindow(k), a) for a in AGGS],
                       **kw)
    ps = p_api.Session(pg, [p_api.QuerySpec(p_api.KHopWindow(k), a) for a in AGGS],
                       torch_device="cpu", **kw)
    return rs, ps


def _state(sess):
    (state,) = sess._states.values()
    return state


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_session_run_and_run_many_bitwise(name):
    rs, ps = _pair(name, 2)
    assert (_state(ps).plan.p1_ell is None) == (name == "ba400_no_ell")
    got, ref = ps.run(), rs.run()
    for a, x, y in zip(AGGS, got, ref):
        assert x.dtype == y.dtype == np.float32 and np.array_equal(x, y), a
    vb = np.random.default_rng(5).integers(0, 100, (4, ps.graph.n)).astype(np.float64)
    many, rmany = ps.run_many(vb), rs.run_many(vb)
    for a, x, y in zip(AGGS, many, rmany):
        assert x.shape == (4, ps.graph.n) and np.array_equal(x, y), a
    for b in range(4):  # a batch row is the unbatched query, bit for bit
        for x, y in zip(many, ps.run(vb[b])):
            assert np.array_equal(x[b], y)


def test_no_ell_run_is_two_k1_calls_and_no_scatter(monkeypatch):
    """Without ELL layouts every channel of run() and run_many() rides one
    K1 call per pass; nothing outside K1 scatters."""
    from repro_torch.kernels.segment_reduce import ops as p_ops

    rs, ps = _pair("ba400_no_ell", 2)
    assert _state(ps).plan.p1_ell is None
    calls, scatters, inside = [], [], [False]
    k1 = p_ops.segment_reduce_tiled

    def counted_k1(values, *args, monoids, **kw):
        calls.append((tuple(values.shape), tuple(monoids)))
        inside[0] = True
        try:
            return k1(values, *args, monoids=monoids, **kw)
        finally:
            inside[0] = False

    def spy(name):
        real = getattr(torch.Tensor, name)

        def scatter(self, *a, **kw):
            if not inside[0]:
                scatters.append(name)
            return real(self, *a, **kw)
        return scatter

    monkeypatch.setattr(p_ops, "segment_reduce_tiled", counted_k1)
    for name in ("scatter_reduce", "scatter_reduce_", "scatter", "scatter_",
                 "scatter_add", "scatter_add_"):
        monkeypatch.setattr(torch.Tensor, name, spy(name))
    got = ps.run()
    assert [m for _, m in calls] == [(1, 1, 1), (2, 1, 1)]
    vb = np.random.default_rng(5).integers(0, 100, (8, ps.graph.n)).astype(np.float64)
    many = ps.run_many(vb)
    assert [(shape[1], m) for shape, m in calls[2:]] == [(24, (8, 8, 8)), (32, (16, 8, 8))]
    assert scatters == []
    for a, x, y in zip(AGGS, got, rs.run()):
        assert np.array_equal(x, y), a
    for a, x, y in zip(AGGS, many, rs.run_many(vb)):
        assert np.array_equal(x, y), a


def test_session_run_normal_values_allclose():
    rs, ps = _pair("er300", 2, integer=False)
    for a, x, y in zip(AGGS, ps.run(), rs.run()):
        np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-5, err_msg=a)


@pytest.mark.parametrize("name", ["er300", "ba400_no_ell"])
def test_query_on_carried_plan_matches_reference(name):
    rs, ps = _pair(name, 2)
    (rstate,) = rs._states.values()
    ridx, rplan = rstate.index, rstate.plan
    idx = convert.dbindex_from_arrays({
        "n": ridx.n, "num_blocks": ridx.num_blocks, "stats": ridx.stats,
        **{f: getattr(ridx, f) for f in convert.DBINDEX_FIELDS}})
    assert_same_fields(plan_fields(et.plan_from_dbindex(idx, headroom=0.5,
                                                        torch_device="cpu")),
                       plan_fields(rplan))
    plan = convert.dbindex_plan_from_arrays(plan_fields(rplan), torch_device="cpu")
    assert_same_fields(plan_fields(plan), plan_fields(rplan))
    vals = rs.graph.attrs["val"]
    got = et.query_dbindex_multi(plan, vals, AGGS)
    ref = ej.query_dbindex_multi(rplan, vals, AGGS)
    for a, x, y in zip(AGGS, got, ref):
        assert np.array_equal(x.numpy(), np.asarray(y)), a
        assert np.array_equal(et.query_dbindex(plan, vals, a).numpy(),
                              np.asarray(ej.query_dbindex(rplan, vals, a))), a


def _batches(n_edges_of, n, seed, count, ins, dels):
    rng = np.random.default_rng(seed)
    for _ in range(count):
        s, d = rng.integers(0, n, ins), rng.integers(0, n, ins)
        src, dst = n_edges_of()
        e = rng.choice(src.size, dels, replace=False)
        yield (np.concatenate([s, src[e]]), np.concatenate([d, dst[e]]),
               np.concatenate([np.ones(ins, np.int8), -np.ones(dels, np.int8)]))


@pytest.mark.parametrize("use_device_bfs", [True, False])
@pytest.mark.parametrize("name,k,ins,dels,stable", [
    ("er300", 1, 2, 2, True),
    ("er2000", 1, 4, 2, True),
    ("er300", 2, 4, 2, False),  # the staleness policy reorganizes: shapes move
])
def test_stream_matches_reference_every_version(name, k, ins, dels, stable,
                                                use_device_bfs):
    rs, ps = _pair(name, k, use_device_bfs=use_device_bfs, plan_headroom=1.0)
    ps.run()
    count0 = p_api.recompile_count()
    for s, d, op in _batches(lambda: (ps.graph.src, ps.graph.dst), ps.graph.n,
                             seed=13, count=20, ins=ins, dels=dels):
        rrep = rs.update(r_updates.UpdateBatch(s, d, op))
        prep = ps.update(p_updates.UpdateBatch(s, d, op))
        assert rrep.keys() == prep.keys()
        for key in rrep:
            assert np.array_equal(rrep[key]["affected_owners"],
                                  prep[key]["affected_owners"])
            assert rrep[key]["reorganized"] == prep[key]["reorganized"]
        assert_same_fields(plan_fields(_state(rs).plan), plan_fields(_state(ps).plan))
        for a, x, y in zip(AGGS, ps.run(), rs.run()):
            assert np.array_equal(x, y), a
        if stable:
            assert p_api.recompile_count() == count0
    assert ps.version == rs.version == 20


def test_session_needs_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    g = p_gen.with_random_attrs(p_gen.erdos_renyi(50, 3.0, seed=1))
    with pytest.raises(RuntimeError, match="torch_device"):
        p_api.Session(g, [p_api.QuerySpec(p_api.KHopWindow(1), "sum")])


def _plan_ptrs(plan) -> dict:
    return {k: t.data_ptr() for k, t in plan.named_arrays().items()}


def test_pinned_view_answers_at_its_version_across_three_updates():
    """Copy-on-write: the first update clones the plan the view holds and
    patches the clone, so the view answers bitwise as a fresh session on
    its version's graph after three updates, run() and run_many() alike,
    with no new plan signature; the head answers at the head."""
    rs, ps = _pair("er300", 2, plan_headroom=1.0)
    g0 = ps.graph
    vb = np.random.default_rng(5).integers(0, 100, (3, g0.n)).astype(np.float64)
    view = ps.snapshot()
    view.run(), view.run_many(vb)
    held = _plan_ptrs(_state(ps).plan)
    count0 = p_api.recompile_count()
    for s, d, op in _batches(lambda: (ps.graph.src, ps.graph.dst), g0.n,
                             seed=21, count=3, ins=4, dels=2):
        rep = ps.update(p_updates.UpdateBatch(s, d, op))
        rs.update(r_updates.UpdateBatch(s, d, op))
        assert rep["khop[2]/dbindex"]["plan_clone_bytes"] == (
            _state(ps).plan.plan_nbytes() if ps.version == 1 else 0)
    assert ps.plan_clones == 1 and view.version == 0 and ps.version == 3
    assert _plan_ptrs(view.artifacts[0][0][1]) == held  # the view's plan kept its storage
    pinned = view.run(), view.run_many(vb)
    assert p_api.recompile_count() == count0
    fresh = p_api.Session(g0, [p_api.QuerySpec(p_api.KHopWindow(2), a) for a in AGGS],
                          torch_device="cpu")
    for got, want in zip(pinned, (fresh.run(), fresh.run_many(vb))):
        for a, x, y in zip(AGGS, got, want):
            assert x.dtype == y.dtype and np.array_equal(x, y), a
    for a, x, y in zip(AGGS, ps.run(), rs.run()):
        assert np.array_equal(x, y), a


def test_update_without_live_view_patches_in_place():
    """With no live view (``run()``'s view dies with the call) the plan is
    patched in place: every plan tensor keeps its storage, nothing is
    cloned, and the results still match the reference."""
    rs, ps = _pair("er300", 1, plan_headroom=1.0)
    ps.run()
    before = _plan_ptrs(_state(ps).plan)
    for s, d, op in _batches(lambda: (ps.graph.src, ps.graph.dst), ps.graph.n,
                             seed=22, count=3, ins=2, dels=2):
        rep = ps.update(p_updates.UpdateBatch(s, d, op))
        rs.update(r_updates.UpdateBatch(s, d, op))
        assert rep["khop[1]/dbindex"]["plan_clone_bytes"] == 0
        for a, x, y in zip(AGGS, ps.run(), rs.run()):
            assert np.array_equal(x, y), a
    after = _plan_ptrs(_state(ps).plan)
    patched_in_place = ("pass1.gather_padded", "pass1.seg_tiles", "pass2.gather_padded",
                        "pass2.seg_tiles", "p1_ell", "p2_ell")
    assert {k: after[k] for k in patched_in_place} == {k: before[k] for k in patched_in_place}
    assert ps.plan_clones == 0 and ps.plan_clone_bytes == 0


def test_session_records_metrics_and_spans():
    from repro_torch import obs

    reg, tracer = obs.MetricsRegistry(), obs.Tracer()
    g = p_gen.with_random_attrs(p_gen.erdos_renyi(200, 4.0, seed=8), seed=9)
    sess = p_api.Session(g, [p_api.QuerySpec(p_api.KHopWindow(2), a) for a in AGGS],
                         obs=reg, tracer=tracer, torch_device="cpu")
    sess.run()
    sess.update(p_updates.UpdateBatch.inserts([1, 2], [30, 40]))
    assert reg.counter("repro_session_updates_total").value == 1
    assert reg.histogram("repro_index_update_seconds",
                         labels=("kind",)).labels("dbindex").count == 1
    names = {e["name"] for e in tracer.events()}
    assert {"session.update", "maintain", "index.update", "query.group",
            "query.term"} <= names


def _composite_pair(expr_of, aggs, **kw):
    g = lambda gen: gen.with_random_attrs(  # noqa: E731
        gen.erdos_renyi(200, 4.0, directed=True, seed=17), seed=18)
    rg, pg = g(r_gen), g(p_gen)
    flag = (np.arange(200) % 3 != 0).astype(np.float64)
    rg, pg = rg.with_attr("flag", flag), pg.with_attr("flag", flag)
    rs = r_api.Session(rg, [r_api.QuerySpec(expr_of(r_win), a) for a in aggs], **kw)
    ps = p_api.Session(pg, [p_api.QuerySpec(expr_of(p_win), a) for a in aggs],
                       torch_device="cpu", **kw)
    return rs, ps


def _union(w):
    return w.Union(w.KHop(1, "out"), w.KHop(1, "in"))


def _filtered(w):
    return w.Filter(w.KHop(2, "out"), "flag")


@pytest.mark.parametrize("aggs", [("min", "max"), AGGS])
@pytest.mark.parametrize("expr_of", [_union, _filtered])
def test_composite_windows_match_reference(expr_of, aggs):
    """A Union of direction-aware leaves takes the algebraic fast path
    (idempotent combine for min/max, inclusion–exclusion once a sum channel
    is involved); a Filter takes the generic materialized lowering."""
    rs, ps = _composite_pair(expr_of, aggs)
    assert [p is None for p in ps._programs] == [p is None for p in rs._programs]
    batches = [
        (np.array([1, 5, 9]), np.array([7, 3, 120]), np.ones(3, np.int8)),
        "val", "flag",  # attribute edits; a Filter predicate edit moves windows
    ]
    for b in [None] + batches:
        if isinstance(b, tuple):
            rs.update(r_updates.UpdateBatch(*b))
            ps.update(p_updates.UpdateBatch(*b))
        elif b is not None:
            verts, vals = [0, 3, 6, 7], np.array([50.0, 0.0, 1.0, 0.0])
            rs.update(r_updates.UpdateBatch.attr_set(b, verts, vals))
            ps.update(p_updates.UpdateBatch.attr_set(b, verts, vals))
        for a, x, y in zip(aggs, ps.run(), rs.run()):
            assert np.array_equal(x, y), (b, a)


@pytest.mark.parametrize("engine", ["nonindex", "bitset", "dbindex"])
def test_pinned_host_engines_match_reference(engine):
    rs, ps = _pair("er300", 2)
    vals = rs.graph.attrs["val"]
    rw, pw = r_api.KHopWindow(2), p_api.KHopWindow(2)
    ref = r_api.DEFAULT_REGISTRY.run(engine, rs.graph, rw, vals, AGGS)
    got = p_api.DEFAULT_REGISTRY.run(engine, ps.graph, pw, vals, AGGS)
    for a in AGGS:
        assert got[a].dtype == ref[a].dtype and np.array_equal(got[a], ref[a]), a

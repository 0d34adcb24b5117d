"""The port's EAGR engine and ``GraphWindowQuery`` shim against the
reference's, and the registry's selection, on the CPU.

EAGR's overlay build is deterministic, so both packages mine the same
virtual nodes from the same graph and answer bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.core.api as r_api  # noqa: E402
from repro.core import eagr as r_eagr  # noqa: E402
from repro.core import query as r_query  # noqa: E402
from repro.core import updates as r_updates  # noqa: E402
from repro.graphs import generators as r_gen  # noqa: E402

import repro_torch.core.api as p_api  # noqa: E402
from repro_torch.core import eagr as p_eagr  # noqa: E402
from repro_torch.core import query as p_query  # noqa: E402
from repro_torch.core import updates as p_updates  # noqa: E402
from repro_torch.graphs import generators as p_gen  # noqa: E402

AGGS = ("sum", "count", "avg", "min", "max")
GRAPHS = {
    "er150": lambda gen: gen.erdos_renyi(150, 4.0, seed=3),
    "dag150": lambda gen: gen.random_dag(150, 3.0, seed=5, locality=30),
}


def _graphs(name):
    return (r_gen.with_random_attrs(GRAPHS[name](r_gen), seed=2),
            p_gen.with_random_attrs(GRAPHS[name](p_gen), seed=2))


def _windows(name):
    if name.startswith("dag"):
        return r_api.TopologicalWindow(), p_api.TopologicalWindow()
    return r_api.KHopWindow(2), p_api.KHopWindow(2)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_eagr_overlay_and_queries_match_reference(name):
    rg, pg = _graphs(name)
    rw, pw = _windows(name)
    ridx = r_eagr.build_eagr(rg, rw, iterations=3, chunk_size=64)
    pidx = p_eagr.build_eagr(pg, pw, iterations=3, chunk_size=64)
    assert pidx.stats["num_virtual"] == ridx.stats["num_virtual"] > 0
    assert all(np.array_equal(a, b) for a, b in zip(pidx.overlay, ridx.overlay))
    assert all(np.array_equal(a, b)
               for a, b in zip(pidx.virtual_members, ridx.virtual_members))
    vals = rg.attrs["val"]
    for a in AGGS:
        x, y = pidx.query(vals, a), ridx.query(vals, a)
        assert x.dtype == y.dtype and np.array_equal(x, y), a
    ref = r_api.DEFAULT_REGISTRY.run("eagr", rg, rw, vals, AGGS, iterations=2, chunk_size=32)
    got = p_api.DEFAULT_REGISTRY.run("eagr", pg, pw, vals, AGGS, iterations=2, chunk_size=32)
    for a in AGGS:
        assert np.array_equal(got[a], ref[a]), a


def test_eagr_memory_limit_raises():
    _, pg = _graphs("er150")
    with pytest.raises(MemoryError):
        p_eagr.build_eagr(pg, p_api.KHopWindow(2), memory_limit_bytes=1024)


@pytest.mark.parametrize("engine", ["nonindex", "bitset", "eagr", "dbindex", "iindex",
                                    "torch", "torch-iindex"])
def test_graph_window_query_shim_matches_reference(engine):
    rg, pg = _graphs("dag150")
    rw, pw = _windows("dag150")
    ref_engine = {"torch": "jax", "torch-iindex": "jax-iindex"}.get(engine, engine)
    kw = {"use_pallas": False} if ref_engine.startswith("jax") else {}
    pkw = {"torch_device": "cpu"} if engine.startswith("torch") else {}
    want = r_query.brute_force(rg, rw, rg.attrs["val"], "avg", dtype=np.float32)
    assert np.array_equal(p_query.brute_force(pg, pw, pg.attrs["val"], "avg",
                                              dtype=np.float32), want)
    got = p_query.GraphWindowQuery(pw, agg="avg").run(pg, engine=engine, **pkw)
    ref = r_query.GraphWindowQuery(rw, agg="avg").run(rg, engine=ref_engine, **kw)
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    if engine.startswith("torch"):
        assert got.dtype == np.float32 and np.array_equal(got, want)
    else:
        assert np.array_equal(got, ref)


@pytest.mark.parametrize("window,engine", [("topological", "torch-iindex"),
                                           (("khop", 2), "torch")])
def test_registry_selects_device_engines(window, engine):
    w = p_api.as_window(window)
    assert p_api.DEFAULT_REGISTRY.select(w, AGGS) == engine
    assert r_api.DEFAULT_REGISTRY.select(r_api.as_window(window), AGGS) == (
        "jax-iindex" if engine == "torch-iindex" else "jax")
    # the host engines behind them, when the device is ruled out
    assert p_api.DEFAULT_REGISTRY.select(w, AGGS, device=False) == (
        "iindex" if engine == "torch-iindex" else "dbindex")
    def rows(reg):  # every field but the package's own aggregate registry
        return {c.name: (c.windows, c.device, c.sharded, c.incremental, c.priority)
                for c in reg.capabilities()}

    caps, rcaps = rows(p_api.DEFAULT_REGISTRY), rows(r_api.DEFAULT_REGISTRY)
    for name in ("nonindex", "bitset", "eagr", "dbindex", "iindex"):
        assert caps[name] == rcaps[name], name
    caps = {c.name: c for c in p_api.DEFAULT_REGISTRY.capabilities()}
    rcaps = {c.name: c for c in r_api.DEFAULT_REGISTRY.capabilities()}
    assert caps["torch-iindex"].priority == rcaps["jax-iindex"].priority == 60
    assert caps["torch-iindex"].windows == ("topological",)


def test_pinned_eagr_session_rebuilds_lazily_after_updates():
    rg, pg = _graphs("er150")
    specs = lambda api: [api.QuerySpec(api.KHopWindow(1), a, engine="eagr")  # noqa: E731
                         for a in AGGS]
    rs, ps = r_api.Session(rg, specs(r_api)), p_api.Session(pg, specs(p_api),
                                                            torch_device="cpu")
    assert [g.engine for g in ps.compiled.groups] == ["eagr"]
    assert ps._states == {}
    for a, x, y in zip(AGGS, ps.run(), rs.run()):
        assert np.array_equal(x, y), a
    (first,) = ps._eagr.values()
    batch = (np.array([1, 4]), np.array([90, 120]), np.ones(2, np.int8))
    rs.update(r_updates.UpdateBatch(*batch))
    ps.update(p_updates.UpdateBatch(*batch))
    assert ps._eagr_dirty
    for a, x, y in zip(AGGS, ps.run(), rs.run()):
        assert np.array_equal(x, y), a
    (second,) = ps._eagr.values()
    assert second is not first and not ps._eagr_dirty

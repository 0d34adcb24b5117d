"""EXPLAIN and ANALYZE, port vs reference, on the CPU.

* **Footprint** — ``plan_nbytes()`` is ``numel() * element_size()`` of
  every tensor the plan holds, array by array, for the DBIndex and the
  I-Index plan; the DBIndex plan's arrays are the reference's, byte for
  byte, and so is ``WindowService.debug_report()``'s plan footprint.
* **EXPLAIN** — the same report as the reference's for the same session,
  engine names mapped (``jax`` → ``torch``, ``jax-iindex`` →
  ``torch-iindex``): every candidate's verdict and reason, the lowering
  choice, index anatomy, the DBIndex plan anatomy; no execution, no new
  plan signature, stable over 10 streamed batches.
* **ANALYZE** — the port's phases (``host_prep``, ``pass1_reduce``,
  ``pass2_reduce``, ``finalize`` on a DBIndex term; ``host_prep``,
  ``wd_reduce``, ``inherit``, ``finalize`` on an I-Index term;
  ``host_combine`` for an algebraic program), at least 95 % of the wall
  time attributed at the reference test's sizes, results bitwise
  ``run()``'s, ``recompile_count()`` unmoved.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_replica import PORT, REF, stream  # noqa: E402
from test_torch_service import _same, khop_batch  # noqa: E402

ENGINE = {"jax": "torch", "jax-iindex": "torch-iindex", "jax-sharded": "torch-sharded"}


def _er(pkg, n, deg, seed, directed=False):
    return pkg.gen.with_random_attrs(
        pkg.gen.erdos_renyi(n, deg, directed=directed, seed=seed), seed=seed + 1)


def _dag(pkg, n=300):
    return pkg.gen.with_random_attrs(pkg.gen.random_dag(n, 2.5, seed=5), seed=6)


def _session(pkg, g, specs, **kw):
    return pkg.api.Session(g, specs, device=True, **pkg.session_kw, **kw)


def _plan(sess):
    (state,) = sess._states.values()
    return state.plan


def _nbytes(t):
    return t.numel() * t.element_size()


# ---------------------------------------------------------------------- #
#  Byte-exact plan memory accounting
# ---------------------------------------------------------------------- #
def _tileplan_actual(prefix, tp):
    return {f"{prefix}.{k}": _nbytes(getattr(tp, k))
            for k in ("gather_padded", "seg_tiles", "m2out", "first_visit")}


def test_dbindex_plan_nbytes_byte_exact_and_equal_to_reference():
    specs = [PORT.api.QuerySpec(("khop", 1), "sum")]
    sess = _session(PORT, _er(PORT, 300, 4.0, 1), specs)
    plan = _plan(sess)
    assert type(plan).__name__ == "DBIndexPlan"
    actual = {**_tileplan_actual("pass1", plan.pass1), **_tileplan_actual("pass2", plan.pass2),
              "block_sizes": _nbytes(plan.block_sizes), "link_counts": _nbytes(plan.link_counts)}
    if plan.p1_ell is not None:
        actual.update(p1_ell=_nbytes(plan.p1_ell), p2_ell=_nbytes(plan.p2_ell))
    assert plan.array_nbytes() == actual  # array by array, not just in total
    assert plan.plan_nbytes() == sum(actual.values())
    rep = sess.explain()
    assert rep.groups[0].terms[0].plan_nbytes == plan.plan_nbytes()
    assert rep.total_plan_nbytes == plan.plan_nbytes()
    ref = _session(REF, _er(REF, 300, 4.0, 1), [REF.api.QuerySpec(("khop", 1), "sum")])
    assert _plan(ref).array_nbytes() == plan.array_nbytes()
    assert ref.explain().total_plan_nbytes == rep.total_plan_nbytes


def test_iindex_plan_nbytes_byte_exact():
    sess = _session(PORT, _dag(PORT), [PORT.api.QuerySpec("topological", "sum")])
    plan = _plan(sess)
    assert type(plan).__name__ == "IIndexPlan"
    actual = _tileplan_actual("wd_plan", plan.wd_plan)
    f = plan.forest
    actual.update({"pid": _nbytes(f.pid), "order": _nbytes(f.order),
                   "level_ptr": _nbytes(f.level_ptr),
                   "chains.vertices": _nbytes(f.chains.vertices),
                   "chains.ptr": _nbytes(f.chains.ptr),
                   "chains.head_parent": _nbytes(f.chains.head_parent),
                   "level": _nbytes(plan.level), "wd_sizes": _nbytes(plan.wd_sizes)})
    assert plan.array_nbytes() == actual
    assert plan.plan_nbytes() == sum(actual.values())
    assert sess.explain().total_plan_nbytes == plan.plan_nbytes()
    # the arrays the reference's plan also holds take the same bytes
    ref = _session(REF, _dag(REF), [REF.api.QuerySpec("topological", "sum")])
    for key, nb in _plan(ref).array_nbytes().items():
        assert actual[key] == nb, key


# ---------------------------------------------------------------------- #
#  EXPLAIN against the reference's report
# ---------------------------------------------------------------------- #
def _explain_view(rep):
    """The parts of a report both packages must agree on, engine names
    mapped to the port's."""
    out = {"n": rep.n_vertices, "m": rep.n_edges, "version": rep.version,
           "sharded": rep.sharded, "groups": []}
    for g in rep.groups:
        cands = {ENGINE.get(c["name"], c["name"]): (c["selected"], c["reason"].replace(
            "'jax'", "'torch'")) for c in g.candidates}
        low = dict(g.lowering)
        low["reason"] = low["reason"].replace("'jax-iindex'", "'torch-iindex'").replace(
            "'jax'", "'torch'")
        terms = []
        for t in g.terms:
            plan = dict(t.plan)
            plan.pop("chains", None)  # the port's chain layout (no reference counterpart)
            terms.append((t.window, t.index_kind, t.index, t.plan_kind, plan,
                          t.state.get("plan_version")))
        out["groups"].append({
            "window": g.window, "kind": g.window_kind, "attr": g.attr, "aggs": g.aggs,
            "engine": ENGINE.get(g.engine, g.engine),
            "priority": g.capability["priority"], "candidates": cands,
            "lowering": low, "terms": terms})
    return out


CASES = {
    "khop": lambda pkg: _session(pkg, _er(pkg, 200, 4.0, 1), [
        pkg.api.QuerySpec(("khop", 1), "sum"), pkg.api.QuerySpec(("khop", 2), "min")]),
    "topological": lambda pkg: _session(pkg, _dag(pkg), [
        pkg.api.QuerySpec("topological", "sum"), pkg.api.QuerySpec("topological", "max")]),
    "union_min": lambda pkg: _session(pkg, _er(pkg, 250, 4.0, 3, directed=True), [
        pkg.api.QuerySpec(pkg.windows.Union(pkg.windows.KHop(2, "in"), pkg.windows.KHopWindow(2)),
                          "min")]),
    "union_sum": lambda pkg: _session(pkg, _er(pkg, 250, 4.0, 3, directed=True), [
        pkg.api.QuerySpec(pkg.windows.Union(pkg.windows.KHop(2, "in"), pkg.windows.KHopWindow(2)),
                          "sum")]),
    "host_engine": lambda pkg: pkg.api.Session(_er(pkg, 150, 3.0, 9), [
        pkg.api.QuerySpec(("khop", 1), "sum", engine="dbindex"),
        pkg.api.QuerySpec(pkg.windows.Intersect(pkg.windows.KHop(1), pkg.windows.KHop(2)), "avg")],
        device=False, **pkg.session_kw),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_explain_matches_reference_report(case):
    ref, port = CASES[case](REF), CASES[case](PORT)
    r, p = _explain_view(ref.explain()), _explain_view(port.explain())
    assert p["groups"] and len(p["groups"]) == len(r["groups"])
    for rg, pg in zip(r["groups"], p["groups"]):
        # every candidate, the sharded engine included, has the
        # reference's verdict and reason
        assert set(pg["candidates"]) == set(rg["candidates"])
        for name, verdict in pg["candidates"].items():
            assert verdict == rg["candidates"][name], name
        assert all(reason for _, reason in pg["candidates"].values())
    for g in (r, p):
        for grp in g["groups"]:
            grp.pop("candidates")
    assert p == r


def test_explain_candidates_carry_rejection_reasons():
    sess = CASES["khop"](PORT)
    grp = sess.explain().groups[0]
    assert grp.engine == "torch"
    by_name = {c["name"]: c for c in grp.candidates}
    assert by_name["torch"]["selected"]
    assert "priority 30 < 50" in by_name["dbindex"]["reason"]
    assert "not served" in by_name["torch-iindex"]["reason"]
    topo = CASES["topological"](PORT).explain().groups[0]
    assert topo.engine == "torch-iindex" and topo.capability["priority"] == 60
    assert {c["name"]: c["reason"] for c in topo.candidates}["torch"] == \
        "covers the query but priority 50 < 60"
    assert topo.terms[0].plan["chains"] > 0 and topo.terms[0].plan["max_level"] > 0


def test_explain_does_not_execute_or_move_recompile_count(monkeypatch):
    from repro_torch.kernels.inherit_scan import ops as scan_ops
    from repro_torch.kernels.segment_reduce import ops as k1_ops

    def boom(*a, **k):
        raise AssertionError("EXPLAIN launched a kernel")

    sessions = [CASES["khop"](PORT), CASES["topological"](PORT)]
    monkeypatch.setattr(k1_ops, "segment_reduce_tiled", boom)
    monkeypatch.setattr(scan_ops, "inherit_scan", boom)
    c0 = PORT.api.recompile_count()
    for sess in sessions:
        rep = sess.explain()
        json.loads(rep.to_json())  # fully serializable
        assert "engine: torch" in rep.text()
    assert PORT.api.recompile_count() == c0


def test_explain_stable_across_streamed_batches():
    g = _er(PORT, 400, 4.0, 11)
    specs = [PORT.api.QuerySpec(("khop", 1), a) for a in ("sum", "min", "avg")]
    sess = _session(PORT, g, specs, plan_headroom=1.0)
    sess.run()
    first = sess.explain()
    lowering0 = first.groups[0].lowering["choice"]
    nbytes0 = first.total_plan_nbytes
    rng = np.random.default_rng(13)
    for step in range(10):
        sess.update(PORT.updates.UpdateBatch(*khop_batch(sess.graph, rng, 4, 2)))
        rep = sess.explain()
        assert rep.groups[0].lowering["choice"] == lowering0
        assert rep.groups[0].engine == first.groups[0].engine
        # static shapes: plan patching never changes the footprint
        assert rep.total_plan_nbytes == nbytes0, step
        assert rep.version == step + 1


def test_explain_spec_filter_selects_one_group():
    sess = CASES["khop"](PORT)
    specs = sess.compiled.specs
    assert len(sess.explain().groups) == 2
    only = sess.explain(specs[1])
    assert len(only.groups) == 1 and only.groups[0].window == "khop[2]"
    assert sess.explain(0).groups[0].window == "khop[1]"
    with pytest.raises(KeyError):
        sess.explain(PORT.api.QuerySpec(("khop", 3), "sum"))


# ---------------------------------------------------------------------- #
#  ANALYZE: the port's phases, attribution, results
# ---------------------------------------------------------------------- #
def _results_are_runs(sess, rep):
    for (gi, ai), want in zip(sess.compiled.spec_slots, sess.run()):
        got = rep.results[gi][sess.compiled.groups[gi].aggs[ai]]
        assert _same(got, want), (gi, ai)


def _phases(rep, term=None):
    return {p["phase"] for p in rep.phases if term is None or p["term"] == term}


def test_analyze_attributes_wall_time_and_keeps_signatures():
    g = _er(PORT, 2000, 8.0, 21)
    specs = [PORT.api.QuerySpec(("khop", 1), a) for a in ("sum", "min", "avg")]
    sess = _session(PORT, g, specs)
    sess.run()
    c0 = PORT.api.recompile_count()
    sess.analyze()  # warm the eager dispatch path
    rep = sess.analyze()
    assert rep.attribution >= 0.95, rep.attribution
    assert PORT.api.recompile_count() == c0
    assert _phases(rep, "khop[1]") == {"host_prep", "pass1_reduce", "pass2_reduce", "finalize"}
    assert _phases(rep) == {"host_prep", "pass1_reduce", "pass2_reduce", "finalize"}
    _results_are_runs(sess, rep)
    txt = rep.text()
    for name in sorted(_phases(rep)):
        assert name in txt
    d = json.loads(rep.to_json())
    assert "results" not in d and d["version"] == 0


def test_analyze_launches_one_k1_per_pass(monkeypatch):
    """Each DBIndex term's two reduce phases are one K1 call each (the
    executor's own pass functions), an I-Index term's one K1 call and one
    scan call."""
    from repro_torch.kernels.inherit_scan import ops as scan_ops
    from repro_torch.kernels.segment_reduce import ops as k1_ops

    calls = []
    k1, scan = k1_ops.segment_reduce_tiled, scan_ops.inherit_scan
    monkeypatch.setattr(k1_ops, "segment_reduce_tiled",
                        lambda *a, **k: calls.append("k1") or k1(*a, **k))
    monkeypatch.setattr(scan_ops, "inherit_scan",
                        lambda *a, **k: calls.append("scan") or scan(*a, **k))
    khop = _session(PORT, _er(PORT, 500, 4.0, 2),
                    [PORT.api.QuerySpec(("khop", 2), a) for a in ("sum", "count", "avg",
                                                                    "min", "max")])
    state = next(iter(khop._states.values()))
    assert state.plan.p1_ell is not None  # the ELL path: min/max ride the dense gather
    khop.analyze()
    assert calls == ["k1", "k1"]
    calls.clear()
    topo = _session(PORT, _dag(PORT), [PORT.api.QuerySpec("topological", a)
                                       for a in ("sum", "count", "min", "max")])
    rep = topo.analyze()
    assert calls == ["k1", "scan"]
    _results_are_runs(topo, rep)


def test_analyze_iindex_and_composite_phases():
    s_topo = _session(PORT, _dag(PORT), [PORT.api.QuerySpec("topological", "sum"),
                                         PORT.api.QuerySpec("topological", "min")])
    s_topo.run()
    c0 = PORT.api.recompile_count()
    s_topo.analyze()
    rep = s_topo.analyze()
    assert rep.attribution >= 0.95, rep.attribution
    assert _phases(rep) == {"host_prep", "wd_reduce", "inherit", "finalize"}
    _results_are_runs(s_topo, rep)

    g = _er(PORT, 600, 5.0, 3, directed=True)
    u = PORT.windows.Union(PORT.windows.KHop(2, "in"), PORT.windows.KHopWindow(2))
    s_u = _session(PORT, g, [PORT.api.QuerySpec(u, "sum")])
    s_u.run()
    assert PORT.api.recompile_count() > c0  # run() records its plans' signatures
    c0 = PORT.api.recompile_count()
    s_u.analyze()
    rep = max((s_u.analyze() for _ in range(2)), key=lambda r: r.attribution)
    assert rep.attribution >= 0.95, rep.attribution
    # three dbindex terms (A, B, A∩B) plus the host-side recombination
    assert "host_combine" in _phases(rep)
    assert len({p["term"] for p in rep.phases} - {"-"}) == 3
    _results_are_runs(s_u, rep)
    assert PORT.api.recompile_count() == c0


def test_analyze_host_terms_and_explicit_values():
    sess = CASES["host_engine"](PORT)
    vals = np.random.default_rng(4).integers(0, 100, sess.graph.n).astype(np.float64)
    rep = sess.analyze(values=vals)
    assert _phases(rep) == {"host_prep", "materialize"}
    for (gi, ai), want in zip(sess.compiled.spec_slots, sess.run(vals)):
        assert _same(rep.results[gi][sess.compiled.groups[gi].aggs[ai]], want)
    khop = CASES["khop"](PORT)
    vals = vals[np.arange(khop.graph.n) % vals.size]
    rep = khop.analyze(spec=khop.compiled.specs[1], values=vals)
    assert {p["group"] for p in rep.phases} == {1}
    assert _same(rep.results[1]["min"], khop.run(vals)[1])


def test_analyze_follows_a_stream_bitwise():
    sess = _session(PORT, _er(PORT, 300, 3.0, 5),
                    [PORT.api.QuerySpec(PORT.windows.KHopWindow(2), a)
                     for a in ("sum", "count", "avg", "min", "max")], plan_headroom=1.0)
    for arrays in stream("khop", 4):
        sess.update(PORT.updates.UpdateBatch(*arrays))
        rep = sess.analyze()
        assert rep.version == sess.version
        _results_are_runs(sess, rep)


# ---------------------------------------------------------------------- #
#  debug_report's plan footprint
# ---------------------------------------------------------------------- #
def test_debug_report_plan_footprint_equals_reference():
    def service(pkg):
        g = pkg.gen.erdos_renyi(200, 4.0, directed=False, seed=7)
        vals = np.random.default_rng(8).integers(0, 50, g.n)
        g = g.with_attr("val", vals.astype(np.float64))
        sess = pkg.api.Session(g, [pkg.api.QuerySpec(("khop", 1), "sum")], device=True,
                               **pkg.session_kw)
        return pkg.serve.WindowService(sess, bucket=4)

    ref, port = service(REF), service(PORT)
    rep = port.debug_report()
    assert rep["plan_footprint_bytes"] == ref.debug_report()["plan_footprint_bytes"]
    assert rep["plan_footprint_bytes"] == port.session.explain().total_plan_nbytes
    assert rep["plan_footprint_bytes"] == _plan(port.session).plan_nbytes()

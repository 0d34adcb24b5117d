"""The serving tier, port vs reference, on the CPU: ``WindowService``,
``AsyncWindowService`` and the affected-owner cache over the port's
``Session`` (``torch_device="cpu"``) against the reference package's on the
same seeded script.

Integer-valued attributes make every float32 partial exact, so served
vectors agree bit for bit; the reference runs its plain (``use_pallas=False``)
executors, as its own service tests do.  The scripts interleave point,
full-graph and explicit-values reads with update batches, with readers
pinned behind the write head (``auto_flip=False``) or following it, and
hold the cache's hit, miss and invalidation counts equal too.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.core.api as r_api  # noqa: E402
import repro.serve.window_service as r_ws  # noqa: E402
from repro.core import updates as r_updates  # noqa: E402
from repro.graphs import generators as r_gen  # noqa: E402

import repro_torch.core.api as p_api  # noqa: E402
import repro_torch.serve.window_service as p_ws  # noqa: E402
from repro_torch.core import updates as p_updates  # noqa: E402
from repro_torch.graphs import generators as p_gen  # noqa: E402

from test_torch_cuda import concurrent_service_check, khop_batch  # noqa: E402
from test_torch_engine_iindex import dag_batch  # noqa: E402

KHOP_AGGS = ("sum", "count", "avg", "min", "max")
TOPO_AGGS = ("sum", "count", "min", "max")


class Pkg:
    """One package's names, so one script drives either."""

    def __init__(self, api, ws, updates, gen, **session_kw):
        self.api, self.ws, self.updates, self.gen = api, ws, updates, gen
        self.session_kw = session_kw

    def session(self, g, specs, **kw):
        return self.api.Session(g, specs, **self.session_kw, **kw)

    def batch(self, arrays):
        return self.updates.UpdateBatch(*arrays)


REF = Pkg(r_api, r_ws, r_updates, r_gen, use_pallas=False)
PORT = Pkg(p_api, p_ws, p_updates, p_gen, torch_device="cpu")


def _graph(pkg, kind):
    if kind == "khop":
        return pkg.gen.with_random_attrs(pkg.gen.erdos_renyi(2000, 3.0, seed=5), seed=6)
    return pkg.gen.with_random_attrs(
        pkg.gen.random_dag(1500, 4.0, seed=5, locality=40), seed=6)


def _specs(pkg, kind):
    if kind == "khop":
        return [pkg.api.QuerySpec(pkg.api.KHopWindow(2), a) for a in KHOP_AGGS]
    return [pkg.api.QuerySpec(pkg.api.TopologicalWindow(), a) for a in TOPO_AGGS]


def make_session(pkg, kind, **kw):
    g = _graph(pkg, kind)
    return g, pkg.session(g, _specs(pkg, kind), plan_headroom=1.0, **kw)


def next_batch(kind, g, rng):
    return khop_batch(g, rng) if kind == "khop" else dag_batch(g, rng, 6, 2, tail=0.1)


def _same(x, y) -> bool:
    x, y = np.asarray(x), np.asarray(y)
    return x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes()


CACHE_KEYS = ("version", "entries", "hits", "misses", "invalidated", "full_drops")
SERVICE_KEYS = ("served", "failed", "flushes", "batched_launches", "padded_rows",
                "active_version", "head_version", "point_hits", "point_misses")


def _script(pkg, kind, auto_flip, steps=4):
    """The seeded script: per step, full and point reads of every spec,
    explicit-values reads (one padded chunk and a partial one), then an
    update; pinned services flip after every second update.  Returns every served
    (result, version, cache_hit), the per-update affected owners and the
    service's counters."""
    g, sess = make_session(pkg, kind)
    svc = pkg.ws.WindowService(sess, bucket=4, auto_flip=auto_flip)
    rng = np.random.default_rng(11)
    served, owners = [], []
    n_specs = len(sess.compiled.specs)
    for step in range(steps):
        verts = rng.integers(0, g.n, 6)
        vals = rng.integers(0, 100, (5, g.n)).astype(np.float64)
        tickets = [svc.submit(si) for si in range(n_specs)]
        tickets += [svc.submit(si, vertex=int(v)) for si in range(n_specs) for v in verts]
        svc.flush()
        tickets += [svc.submit(j % n_specs, vertex=int(verts[j]) if j % 2 else None,
                               values=vals[j]) for j in range(5)]
        tickets += [svc.submit(0, vertex=int(verts[0]))]  # a hit after the refresh
        svc.flush()
        served += [(t.result, t.version, t.cache_hit, t.error) for t in tickets]
        reports = svc.update(pkg.batch(next_batch(kind, svc.session.graph, rng)))
        owners.append({k: np.asarray(r["affected_owners"]) for k, r in reports.items()})
        if not auto_flip and step % 2 == 0:
            svc.flip()
    stats = svc.stats
    counters = {k: stats[k] for k in SERVICE_KEYS}
    counters.update({f"cache.{k}": stats["cache"][k] for k in CACHE_KEYS})
    return served, owners, counters


@pytest.mark.parametrize("auto_flip", [True, False])
@pytest.mark.parametrize("kind", ["khop", "topo"])
def test_service_script_matches_reference(kind, auto_flip):
    ref, got = _script(REF, kind, auto_flip), _script(PORT, kind, auto_flip)
    assert len(ref[0]) == len(got[0])
    for i, ((rr, rv, rh, re), (pr, pv, ph, pe)) in enumerate(zip(ref[0], got[0])):
        assert re is None and pe is None, (i, re, pe)
        assert rv == pv and rh == ph, (i, rv, pv, rh, ph)
        assert _same(pr, rr), i
    for ro, po in zip(ref[1], got[1]):
        assert ro.keys() == po.keys()
        for k in ro:
            assert np.array_equal(ro[k], po[k]), k
    assert ref[2] == got[2]
    assert got[2]["cache.invalidated"] > 0 and got[2]["batched_launches"] > 0
    assert (got[2]["active_version"] < got[2]["head_version"]) == (not auto_flip)


@pytest.mark.parametrize("kind", ["khop", "topo"])
def test_pinned_service_reads_its_version_across_three_updates(kind):
    """Readers pinned at v0 while three batches land answer bitwise as
    they did at v0, through cache bypass and the flush memo (one group
    query per flush), with no new plan signature; ``flip`` then answers as
    a fresh session on the head's graph."""
    g, sess = make_session(PORT, kind)
    svc = p_ws.WindowService(sess, bucket=4, auto_flip=False)
    vals = np.random.default_rng(3).integers(0, 100, g.n).astype(np.float64)
    base = [svc.query(si) for si in range(len(sess.compiled.specs))]
    base_vals = svc.query(0, values=vals)
    count0 = p_api.recompile_count()
    rng = np.random.default_rng(4)
    for _ in range(3):
        svc.update(PORT.batch(next_batch(kind, sess.graph, rng)))
        for si, b in enumerate(base):
            assert _same(svc.query(si), b), si
        assert _same(svc.query(0, values=vals), base_vals)
    assert svc.version == 0 and svc.head_version == 3
    assert sess.plan_clones == 1 and p_api.recompile_count() == count0
    assert svc.flip() == 3
    fresh = PORT.session(sess.graph, _specs(PORT, kind))
    for si, want in enumerate(fresh.run()):
        assert _same(svc.query(si), want), si


# ---------------------------------------------------------------------- #
#  AsyncWindowService on an injected clock (reference
#  tests/test_async_service.py's fake-clock cases, both packages)
# ---------------------------------------------------------------------- #
class FakeClock:
    def __init__(self, t=100.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _small_async(pkg, **kw):
    g = pkg.gen.erdos_renyi(80, 2.5, directed=False, seed=39)
    g = g.with_attr("val", np.random.default_rng(40).integers(0, 50, g.n).astype(np.float64))
    specs = [pkg.api.QuerySpec(pkg.api.KHopWindow(2), "sum"),
             pkg.api.QuerySpec(pkg.api.KHopWindow(2), "min")]
    return pkg.ws.AsyncWindowService(pkg.session(g, specs), **kw)


def _deadline_exactly(pkg, monkeypatch):
    clk = FakeClock()
    svc = _small_async(pkg, bucket=64, now_fn=clk)
    t = svc.submit(0, vertex=3)  # point class: 2 ms deadline
    out = [t.done, len(svc._pending), svc._due_reason()[0],
           round(svc._due_reason()[1] - clk.t, 9)]
    clk.advance(0.002 - 1e-6)
    out += [svc.flush_if_due(), t.done, svc.deadline_flushes]
    clk.advance(1e-6)
    served = svc.flush_if_due()
    out += [[s.rid for s in served], t.done, t.error, svc.deadline_flushes,
            svc.fill_flushes, round(t.latency_s, 9), t.result]
    return out


def _earliest_deadline(pkg, monkeypatch):
    never = pkg.ws.RequestClass("never", max_delay_ms=600_000.0, priority=5,
                                sheddable=True)
    clk = FakeClock()
    svc = _small_async(pkg, bucket=64, classes={"never": never}, now_fn=clk)
    svc.submit(0, request_class="never")
    out = [svc._due_reason()[0], round(svc._due_reason()[1] - clk.t, 6)]
    svc.submit(0, vertex=1)
    out += [svc._due_reason()[0], round(svc._due_reason()[1] - clk.t, 9)]
    clk.advance(0.002)
    served = svc.flush_if_due()
    out += [len(served), svc.deadline_flushes, served[0].result.tobytes(), served[1].result]
    return out


def _fill_beats_deadline(pkg, monkeypatch):
    clk = FakeClock()
    svc = _small_async(pkg, bucket=2, now_fn=clk)
    svc._pending.append(svc._make_ticket(0, None, None, svc.classes["interactive"]))
    clk.advance(60.0)
    svc._pending.append(svc._make_ticket(1, None, None, svc.classes["interactive"]))
    out = [svc._due_reason()[0]]
    served = svc.flush_if_due()
    out += [len(served), svc.fill_flushes, svc.deadline_flushes, svc._due_reason(),
            [s.result.tobytes() for s in served]]
    return out


def _flusher_survives(pkg, monkeypatch):
    with _small_async(pkg, bucket=64) as svc:
        monkeypatch.setattr(pkg.api.SessionView, "run_group",
                            lambda self, gi, values=None:
                            (_ for _ in ()).throw(RuntimeError("boom")))
        bad = svc.submit(0, vertex=0)
        with pytest.raises(RuntimeError, match="boom"):
            bad.get(timeout=10.0)
        monkeypatch.undo()
        alive = svc.running
        ok = svc.submit(0, vertex=0)
        return [alive, ok.get(timeout=10.0), bad.failed, ok.failed]


ASYNC_CASES = {"deadline_exactly": _deadline_exactly, "earliest_deadline": _earliest_deadline,
               "fill_beats_deadline": _fill_beats_deadline,
               "flusher_survives": _flusher_survives}


@pytest.mark.parametrize("case", sorted(ASYNC_CASES))
def test_async_fake_clock_cases_match_reference(case, monkeypatch):
    ref, got = ASYNC_CASES[case](REF, monkeypatch), ASYNC_CASES[case](PORT, monkeypatch)
    assert len(ref) == len(got)
    for i, (r, p) in enumerate(zip(ref, got)):
        if isinstance(r, np.generic):
            assert _same(p, r), i
        else:
            assert r == p, (i, r, p)
    if case == "deadline_exactly":
        assert got[-6] and got[-4] == 1  # served by the deadline flush


# ---------------------------------------------------------------------- #
#  Concurrent service: a flusher thread serves while another thread updates
# ---------------------------------------------------------------------- #
def test_async_service_serves_bitwise_while_another_thread_updates():
    checked, errors, versions, sess = concurrent_service_check("cpu")
    assert checked >= 64 and errors == []
    assert len(versions) >= 2  # tickets were served at more than one version
    assert sess.plan_clones >= 1  # the flusher's view held a plan an update patched


@pytest.mark.parametrize("pkg_name", ["ref", "port"])
def test_cache_write_overtaken_while_building_is_dropped(pkg_name):
    """An invalidation that lands while a ``put_group`` builds its entry
    (another thread's update, simulated by the vector's conversion) must
    not leave the writer's older vector valid at the new version.  The
    port checks the version again under the cache's lock and drops the
    write; the reference stores it (ROADMAP Queue 3)."""
    pkg = {"ref": REF, "port": PORT}[pkg_name]
    cache = pkg.ws.AffectedOwnerCache()
    old = np.arange(6, dtype=np.float32)

    class Racing:
        def __array__(self, dtype=None, copy=None):
            cache.on_update(1, {0: np.array([2])})  # the update's sweep
            return old

    cache.put_group(0, 0, {"sum": Racing()})
    stale = cache.get_point(0, "sum", 2, 1)
    if pkg_name == "port":
        assert stale is None and cache.get_group(0, 1) is None
    else:
        assert stale == old[2]  # the reference serves version 0's value at version 1

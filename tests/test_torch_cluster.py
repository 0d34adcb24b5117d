"""The cluster tier, port vs reference, on the CPU: ``ReplicaSet`` (one
writer over a segmented WAL, followers tailing it, checkpoints, safe
truncation, kill and checkpoint rejoin), ``WindowRouter`` (freshness, then
``min_version``, then least per-class load; failover) and the
``SLOController`` on an injected clock.

The 20-batch stream runs the port's cluster against a reference session
replayed beside it: every routed read is bitwise what the reference
answers at the ticket's pinned version.  The router and controller cases
are the reference's own (``tests/test_cluster.py``), run through both
packages, and must agree.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.core.streaming as r_streaming  # noqa: E402

import repro_torch.core.streaming as p_streaming  # noqa: E402

from test_torch_replica import PORT, REF, _obs_off  # noqa: E402,F401
from test_torch_service import _same, khop_batch  # noqa: E402


def int_graph(pkg, n, deg, seed):
    g = pkg.gen.erdos_renyi(n, deg, directed=False, seed=seed)
    vals = np.random.default_rng(seed + 1).integers(0, 50, g.n)
    return g.with_attr("val", vals.astype(np.float64))


def specs(pkg):
    return [pkg.api.QuerySpec(pkg.api.KHopWindow(2), "sum"),
            pkg.api.QuerySpec(pkg.api.KHopWindow(2), "min")]


def batches(n, deg, seed, count, bseed, ins=4, dels=2):
    """(src, dst, op) arrays drawn against the evolving port graph."""
    g = int_graph(PORT, n, deg, seed)
    rng = np.random.default_rng(bseed)
    out = []
    for _ in range(count):
        arrays = khop_batch(g, rng, ins, dels)
        out.append(arrays)
        g = PORT.updates.apply_batch(g, PORT.updates.UpdateBatch(*arrays))
    return out


def replica_set(pkg, path, n=50, deg=2.5, seed=19, **kw):
    return pkg.serve.ReplicaSet(int_graph(pkg, n, deg, seed), specs(pkg), path,
                                **pkg.session_kw, **kw)


# ---------------------------------------------------------------------- #
#  The 20-batch stream: rotation, checkpoints, truncation, kill, rejoin
# ---------------------------------------------------------------------- #
def test_cluster_stream_bitwise_with_rotation_kill_rejoin(tmp_path):
    """Every routed read, point or full-graph, is bitwise the reference
    session's answer at the ticket's pinned version; every live follower's
    published state equals the mirror at its version; the writer's plan
    shapes are the reference's at every version, so the port
    re-specializes exactly where the reference does."""
    stream = batches(60, 2.5, 17, 20, 18, ins=4, dels=4)
    rs = replica_set(PORT, tmp_path / "c", n=60, seed=17, n_replicas=2,
                     rotate_records=4, checkpoint_every=5)
    mirror = REF.api.Session(int_graph(REF, 60, 2.5, 17), specs(REF), use_pallas=False)
    history = {0: [np.asarray(r) for r in mirror.run()]}
    rng = np.random.default_rng(18)
    for i, arrays in enumerate(stream):
        mirror.update(REF.updates.UpdateBatch(*arrays))
        history[mirror.version] = [np.asarray(r) for r in mirror.run()]
        rs.update(PORT.updates.UpdateBatch(*arrays))
        rs.sync()
        if i == 7:
            assert rs.kill("r0") >= 0
        if i == 12:
            rep = rs.rejoin("r0")
            assert rep.restored_from_version >= 5  # checkpoint, not base
            rs.sync()
        for name, rep in rs.replicas.items():
            if not rep.alive:
                continue
            assert rep.divergence is None and rep.digest_checks > 0
            for x, y in zip(rep.service._active.run(), history[rep.version]):
                assert _same(x, y), (i, name)
        t = rs.router.submit(0, vertex=int(rng.integers(60)))
        rs.router.flush()
        got = t.get(timeout=10)
        assert _same(got, history[t.version][0][t.vertex]), i
        (wstate,), (mstate,) = rs.writer.session._states.values(), mirror._states.values()
        assert wstate.plan.shape_signature()[:4] == tuple(
            tuple(a.shape) for a in (mstate.plan.pass1.gather_padded, mstate.plan.pass1.seg_tiles,
                                     mstate.plan.pass2.gather_padded, mstate.plan.pass2.seg_tiles))
    assert rs.version == 20
    assert rs.wal.rotations >= 3 and rs.wal.truncated_segments >= 1
    assert rs.last_checkpoint_version >= 15
    assert len(PORT.serve.list_checkpoints(rs.checkpoint_dir)) >= 2
    full = rs.router.query(1, request_class="interactive")
    assert _same(full, history[20][1])
    rs.close()


# ---------------------------------------------------------------------- #
#  Router and cluster cases (tests/test_cluster.py), through both packages
# ---------------------------------------------------------------------- #
def _freshest_then_least_loaded(pkg, tmp_path):
    rs = replica_set(pkg, tmp_path / "c", n_replicas=3)
    for arrays in batches(50, 2.5, 19, 3, 8):
        rs.update(pkg.updates.UpdateBatch(*arrays))
    rs.wal.sync()
    rs.replicas["r0"].catch_up()
    rs.replicas["r1"].catch_up()
    rs.replicas["r2"].poll(upto_version=1)
    rs.replicas["r2"].flip()
    t_a = rs.router.submit(0, vertex=1)
    t_b = rs.router.submit(0, vertex=2)
    out = [t_a._route_target, t_b._route_target,
           rs.router.pick("point", min_version=2), rs.router.pick("point", min_version=3),
           rs.router.pick("interactive"), rs.router.inflight("r0")]
    rs.router.flush()
    out += [t_a.get(timeout=10), t_b.get(timeout=10), t_a.version, rs.router.inflight()]
    rs.close()
    return out


def _min_version_fallback(pkg, tmp_path):
    rs = replica_set(pkg, tmp_path / "c", seed=20, n_replicas=1)
    for arrays in batches(50, 2.5, 20, 2, 9):
        rs.update(pkg.updates.UpdateBatch(*arrays))
    rs.wal.sync()
    rs.replicas["r0"].poll(upto_version=1)
    rs.replicas["r0"].flip()
    t = rs.router.submit(0, vertex=3, min_version=2)
    out = [t._route_target]
    rs.router.flush()
    out += [t.get(timeout=10), t.version]
    with pytest.raises(pkg.serve.RoutingError, match="min_version"):
        rs.router.submit(0, vertex=3, min_version=99)
    t2 = rs.router.submit(0, vertex=3, min_version=1)
    rs.router.flush()
    out += [t2._route_target, t2.get(timeout=10), t2.version]
    rs.close()
    return out


def _diverged_and_dead_excluded(pkg, tmp_path):
    rs = replica_set(pkg, tmp_path / "c", seed=21, n_replicas=2)
    for arrays in batches(50, 2.5, 21, 2, 10):
        rs.update(pkg.updates.UpdateBatch(*arrays))
    rs.sync()
    out = [rs.router.pick("point")]
    rs.replicas["r0"].divergence = pkg.audit.AuditFinding(
        source="digest", version=2, expected=b"x", got=b"y", detail="test")
    out.append(rs.router.pick("point"))
    rs.replicas["r1"].kill()
    out.append(rs.router.pick("point"))
    t = rs.router.submit(0, vertex=4)
    rs.router.flush()
    out += [t._route_target, t.get(timeout=10), t.version]
    rs.close()
    return out


def _failover_exactly_the_dead_replicas_tickets(pkg, tmp_path):
    reg = pkg.obs.MetricsRegistry()
    rs = replica_set(pkg, tmp_path / "c", seed=22, n_replicas=2, obs=reg)
    for arrays in batches(50, 2.5, 22, 2, 11):
        rs.update(pkg.updates.UpdateBatch(*arrays))
    rs.sync()
    doomed = [rs.router.submit(0, vertex=v, target="r0") for v in (1, 2, 3)]
    safe = [rs.router.submit(0, vertex=v, target="r1") for v in (4, 5)]
    out = [rs.kill("r0"), [t.failed for t in doomed], [t.failed for t in safe]]
    for t in doomed:
        with pytest.raises(pkg.serve.ReplicaFailedError):
            t.get(timeout=1)
    rs.router.flush()
    mirror = pkg.api.Session.restore_from_wal(int_graph(pkg, 50, 2.5, 22), specs(pkg),
                                              rs.wal_dir, **pkg.session_kw)
    expected = np.asarray(mirror.run()[0])
    out.append([_same(t.get(timeout=10), expected[t.vertex]) for t in safe])
    with pytest.raises(pkg.serve.ReplicaFailedError):
        rs.router.submit(0, vertex=6, target="r0")
    snap = reg.snapshot()
    out += [snap["repro_router_failovers_total"]["values"][0]["value"],
            snap["repro_router_failover_tickets_total"]["values"][0]["value"],
            rs.router.stats["failed_out"], rs.router.failed_tickets]
    t = rs.router.submit(0, vertex=7)
    rs.router.flush()
    out += [t._route_target, t.get(timeout=10)]
    rs.close()
    return out


def _safe_truncation_never_strands_a_cursor(pkg, tmp_path):
    """``safe_truncate_version`` is the newest checkpoint capped by the
    slowest LIVE replica: a lagging follower holds truncation back, a dead
    one does not, and no live cursor ever points below the oldest kept
    segment."""
    rs = replica_set(pkg, tmp_path / "c", seed=23, n_replicas=2, rotate_records=1,
                     checkpoint_every=0)
    stream = batches(50, 2.5, 23, 8, 12)
    out = [rs.safe_truncate_version()]  # no checkpoint yet: nothing truncatable
    for arrays in stream[:4]:
        rs.update(pkg.updates.UpdateBatch(*arrays))
    rs.wal.sync()
    rs.replicas["r0"].catch_up()
    rs.replicas["r1"].poll(upto_version=1)
    rs.checkpoint()  # truncates on checkpoint
    oldest = [b for b, _ in rs.wal.segments()][0]
    out += [rs.last_checkpoint_version, rs.safe_truncate_version(), oldest,
            [rep.cursor["segment"] >= oldest for rep in rs.replicas.values()]]
    rs.kill("r1")  # dead replicas no longer hold truncation back
    removed = [b for b, _ in rs.truncate()]
    oldest = [b for b, _ in rs.wal.segments()][0]
    out += [rs.safe_truncate_version(), removed, oldest,
            rs.replicas["r0"].cursor["segment"] >= oldest]
    for arrays in stream[4:]:
        rs.update(pkg.updates.UpdateBatch(*arrays))
    rs.sync()
    rep = rs.rejoin("r1")
    out += [rep.restored_from_version, rep.version, rs.replicas["r0"].version,
            rs.wal.truncated_segments]
    rs.close()
    return out


def _metrics_survive_obs_reenable(pkg, tmp_path):
    rs = replica_set(pkg, tmp_path / "c", n=40, deg=2.0, seed=25, n_replicas=2)
    for arrays in batches(40, 2.0, 25, 2, 12):
        rs.update(pkg.updates.UpdateBatch(*arrays))
    rs.sync()
    try:
        reg, _ = pkg.obs.enable()
        rs.sync()
        for rep in rs.replicas.values():
            rep.lag
        t = rs.router.submit(0, vertex=1)
        rs.router.flush()
        t.get(timeout=10)
        snap = reg.snapshot()
        lag = snap["repro_replica_lag_versions"]["values"]
        routed = snap["repro_router_requests_total"]["values"]
        prom = reg.prometheus()
        out = [sorted(v["labels"]["replica"] for v in lag),
               [sorted(v["labels"]) for v in routed],
               "repro_replica_polls_total" in snap,
               'repro_replica_lag_versions{replica="r0"}' in prom,
               'repro_replica_lag_versions{replica="r1"}' in prom]
    finally:
        pkg.obs.disable()
        rs.close()
    return out


def _debug_info(pkg, tmp_path):
    rs = replica_set(pkg, tmp_path / "c", n=40, deg=2.0, seed=26, n_replicas=2,
                     rotate_records=2, checkpoint_every=2)
    for arrays in batches(40, 2.0, 26, 5, 13):
        rs.update(pkg.updates.UpdateBatch(*arrays))
    rs.sync()
    info = rs.debug_info()
    for row in info["replicas"].values():
        row["lag"].pop("behind_bytes")
    info["wal"] = {k: info["wal"][k] for k in ("rotations", "truncated_segments")}
    rs.close()
    return [info]


CASES = {"freshest_then_least_loaded": _freshest_then_least_loaded,
         "min_version_fallback": _min_version_fallback,
         "diverged_and_dead_excluded": _diverged_and_dead_excluded,
         "failover_exactly_the_dead_replicas_tickets": _failover_exactly_the_dead_replicas_tickets,
         "safe_truncation_never_strands_a_cursor": _safe_truncation_never_strands_a_cursor,
         "metrics_survive_obs_reenable": _metrics_survive_obs_reenable,
         "debug_info": _debug_info}

EXPECT = {
    "freshest_then_least_loaded": lambda o: {o[0], o[1]} == {"r0", "r1"}
    and o[2] in ("r0", "r1") and o[3] in ("r0", "r1") and o[8] == 3 and o[9] == 0,
    "min_version_fallback": lambda o: o[0] is None and o[2] >= 2 and o[3] == "r0"
    and o[5] == 1,
    "diverged_and_dead_excluded": lambda o: o[:3] == ["r0", "r1", None] and o[3] is None
    and o[5] == 2,
    "failover_exactly_the_dead_replicas_tickets": lambda o: o[0] == 3
    and o[1] == [True] * 3 and o[2] == [False] * 2 and o[3] == [True] * 2
    and o[4:8] == [1.0, 3.0, ["r0"], 3] and o[8] == "r1",
    "safe_truncation_never_strands_a_cursor": lambda o: o[0] == 0 and o[1:3] == [4, 1]
    and all(o[4]) and o[5] == 4 and o[7] > o[3] and o[8] and o[9:12] == [4, 8, 8],
    "metrics_survive_obs_reenable": lambda o: o[0] == ["r0", "r1"] and all(
        lab == ["cls", "target"] for lab in o[1]) and all(o[2:]),
    "debug_info": lambda o: o[0]["checkpoints"]["retained"] == [2, 4]
    and all(r["published_version"] == 5 for r in o[0]["replicas"].values()),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cluster_case_matches_reference(tmp_path, case):
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    ref = CASES[case](REF, tmp_path / "ref")
    got = CASES[case](PORT, tmp_path / "port")
    assert len(got) == len(ref)
    for i, (r, p) in enumerate(zip(ref, got)):
        if isinstance(r, np.generic):
            assert _same(p, r), (i, r, p)
        else:
            assert p == r, (i, r, p)
    assert EXPECT[case](got), got


# ---------------------------------------------------------------------- #
#  SLO-adaptive batching on an injected clock (tests/test_cluster.py)
# ---------------------------------------------------------------------- #
def _slo_window(svc, cls, n, within):
    target_s = svc.classes[cls].max_delay_ms / 1e3
    lat = target_s * (0.5 if within else 2.0)
    for _ in range(n):
        svc.slo.observe(cls, lat, target_s=target_s, outcome="ok")


def _slo_converges(pkg):
    reg = pkg.obs.MetricsRegistry()
    clock = {"t": 0.0}
    svc = pkg.serve.AsyncWindowService(
        pkg.api.Session(int_graph(pkg, 40, 2.0, 23), specs(pkg), **pkg.session_kw),
        bucket=4, obs=reg, now_fn=lambda: clock["t"])
    ctl = pkg.serve.SLOController(svc, min_samples=4, hysteresis=2, min_delay_ms=0.25,
                                  obs=reg)
    trace = []

    def step(n, within):
        _slo_window(svc, "interactive", n, within)
        trace.append((ctl.step()["interactive"], ctl.effective_delay_ms("interactive"),
                      svc.fill_threshold))

    for _ in range(2):
        step(8, False)
    for _ in range(30):
        step(8, False)
    for _ in range(40):
        step(8, True)
    step(2, False)
    snap = reg.snapshot()
    acts = sorted({v["labels"]["action"]
                   for v in snap["repro_slo_controller_decisions_total"]["values"]})
    return [trace, acts, snap["repro_slo_fill_threshold"]["values"][0]["value"],
            svc.classes["interactive"].max_delay_ms]


def _slo_never_violates_declared_deadline(pkg):
    clock = {"t": 100.0}
    svc = pkg.serve.AsyncWindowService(
        pkg.api.Session(int_graph(pkg, 40, 2.0, 24), specs(pkg), **pkg.session_kw),
        bucket=4, now_fn=lambda: clock["t"])
    declared_s = svc.classes["interactive"].max_delay_ms / 1e3
    svc.class_delay_ms["interactive"] = 1e9
    t = svc.submit(0, vertex=1, request_class="interactive")
    out = [t.deadline_s - clock["t"] <= declared_s + 1e-9]
    svc.class_delay_ms["interactive"] = 1.0
    t2 = svc.submit(0, vertex=2, request_class="interactive")
    out.append(round(t2.deadline_s - clock["t"], 12))
    svc.fill_threshold = 2
    out.append(svc._due_reason()[0])
    served = svc.flush("test")
    return out + [[s.result for s in served]]


@pytest.mark.parametrize("case", ["converges", "never_violates_declared_deadline"])
def test_slo_controller_case_matches_reference(case):
    fn = {"converges": _slo_converges,
          "never_violates_declared_deadline": _slo_never_violates_declared_deadline}[case]
    ref, got = fn(REF), fn(PORT)
    assert got == ref
    if case == "converges":
        trace, acts, fill, declared = got
        assert trace[0][0] == "hold" and trace[1][0] == "tighten"
        assert all(0.25 <= d <= declared and 1 <= f <= 4 for _, d, f in trace)
        assert trace[31][1] == pytest.approx(0.25) and trace[31][2] == 1
        assert trace[71][1] == pytest.approx(declared) and trace[71][2] == 4
        assert trace[72][0] == "hold"
        assert {"hold", "tighten", "relax"} <= set(acts) and fill == 4.0
    else:
        assert got[0] and got[1] == pytest.approx(1e-3) and got[2] == "fill"


def test_writer_pressure_reads_the_sessions_policy(tmp_path):
    """The port's writer measures staleness pressure (admission, health)
    against the session's own reorganize policy; the reference's writer
    keeps the default thresholds whatever the session was given
    (``src/repro/serve/cluster.py:127-131``), so a deferred-phase-2
    session reads full pressure there after a few batches."""
    out = {}
    for name, pkg, streaming in (("ref", REF, r_streaming), ("port", PORT, p_streaming)):
        policy = streaming.StalenessPolicy(max_link_ratio=float("inf"),
                                           max_block_ratio=float("inf"),
                                           max_garbage_ratio=1.0)
        (tmp_path / name).mkdir()
        rs = replica_set(pkg, tmp_path / name / "c", n=3000, deg=3.0, n_replicas=1,
                         policy=policy)
        for arrays in batches(3000, 3.0, 19, 3, 8, ins=20, dels=5):
            rs.update(pkg.updates.UpdateBatch(*arrays))
        (staleness,) = rs.writer.session.staleness.values()
        out[name] = (rs.writer.policy is policy, rs.writer.pressure(), staleness)
        rs.close()
    assert out["port"][2] == out["ref"][2]  # the same index, the same growth
    assert out["ref"][2]["link_ratio"] > 1.5  # past the default threshold
    assert out["ref"][:2] == (False, 1.0)
    assert out["port"][:2] == (True, out["port"][2]["garbage_ratio"])

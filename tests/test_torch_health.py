"""Health monitoring, port vs reference, on the CPU: the ``HealthMonitor``
state machine (ready, degraded, failed) over the same signals gives the
same report in both packages; ``HealthServer`` answers ``/metrics``,
``/healthz``, ``/readyz`` and ``/debug`` on an ephemeral port, with the
reference's metric names; the cluster quorum check and its ``/debug``
payload follow the reference through kills and rejoins.
"""

import json
import re
import urllib.error
import urllib.request

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_cluster import batches, int_graph, replica_set, specs  # noqa: E402
from test_torch_replica import PORT, REF, _obs_off  # noqa: E402,F401


class _StubReplica:
    divergence = None
    lag = {"behind_bytes": 0, "unpublished_versions": 0}
    stats = {}


class _StubAuditor:
    mismatches = 0
    stats = {}


def _report(rep):
    return {k: v for k, v in rep.items() if k != "t_unix_s"}


def _state_machine(pkg):
    reg = pkg.obs.MetricsRegistry()
    rep, aud = _StubReplica(), _StubAuditor()
    mon = pkg.serve.HealthMonitor(replicas=[rep], auditors=[aud], obs=reg, max_lag_bytes=100)
    out = [_report(mon.check()), mon.ready]
    rep.lag = {"behind_bytes": 10_000, "unpublished_versions": 0}
    out.append(_report(mon.check()))
    rep.lag = {"behind_bytes": 0, "unpublished_versions": 0}
    aud.mismatches = 2
    out.append(_report(mon.check()))
    aud.mismatches = 0
    rep.divergence = pkg.audit.AuditFinding(source="digest", version=3, wal_offset=99,
                                            detail="graph_crc: ...")
    out.append(_report(mon.check()))
    snap = reg.snapshot()
    out += [snap["repro_health_ready"]["values"][0]["value"],
            snap["repro_health_live"]["values"][0]["value"],
            sorted((v["labels"]["state"], v["value"])
                   for v in snap["repro_health_checks_total"]["values"])]
    return out


def test_health_state_machine_matches_reference():
    ref, got = _state_machine(REF), _state_machine(PORT)
    assert got == ref
    assert [r["state"] for r in got[:1] + got[2:5]] == ["ready", "degraded", "failed", "failed"]
    assert got[2]["failing"] == ["replica_lag"] and got[3]["failing"] == ["audit"]
    assert got[4]["failing"] == ["replica_divergence"]
    assert got[5:7] == [0.0, 1.0]


def _metric_names(text):
    return {m.group(1) for m in re.finditer(r"^([a-z_]+)(?:\{| )", text, re.M)}


def _endpoints(pkg):
    reg, _ = pkg.obs.enable()
    g = int_graph(pkg, 40, 2.5, 7)
    svc = pkg.serve.AsyncWindowService(pkg.api.Session(g, specs(pkg), **pkg.session_kw),
                                       bucket=8, obs=reg)
    svc.query(0, vertex=1)
    aud = pkg.audit.ShadowAuditor(obs=reg)
    svc.attach_auditor(aud)
    mon = pkg.serve.HealthMonitor(service=svc, auditors=[aud], obs=reg)
    out = {}
    with pkg.serve.HealthServer(mon) as hs:
        assert hs.running and hs.port > 0 and hs.url.startswith("http://127.0.0.1:")
        r = urllib.request.urlopen(hs.url + "/readyz", timeout=5)
        out["readyz"] = (r.status, json.loads(r.read()))
        metrics = urllib.request.urlopen(hs.url + "/metrics", timeout=5).read().decode()
        out["metrics"] = _metric_names(metrics)
        out["ready_line"] = "repro_health_ready 1" in metrics
        r = urllib.request.urlopen(hs.url + "/healthz", timeout=5)
        out["healthz"] = (r.status, json.loads(r.read()))
        dbg = json.loads(urllib.request.urlopen(hs.url + "/debug", timeout=5).read())
        out["debug"] = (dbg["health"]["state"], sorted(dbg), sorted(dbg["service"]),
                        dbg["service"]["plan_footprint_bytes"])
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(hs.url + "/nope", timeout=5)
        out["404"] = ei.value.code
        aud.mismatches = 1
        aud.findings.append(pkg.audit.AuditFinding(source="oracle", version=1))
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(hs.url + "/readyz", timeout=5)
        out["readyz_failed"] = (ei.value.code, json.loads(ei.value.read()))
        out["healthz_failed"] = urllib.request.urlopen(hs.url + "/healthz", timeout=5).status
    out["stopped"] = not hs.running
    pkg.obs.disable()
    return out


def test_health_server_endpoints_match_reference():
    ref, got = _endpoints(REF), _endpoints(PORT)
    ref_names, got_names = ref.pop("metrics"), got.pop("metrics")
    assert got == ref
    assert got["readyz"] == (200, {"ready": True, "state": "ready", "failing": []})
    assert got["readyz_failed"][0] == 503 and got["readyz_failed"][1]["failing"] == ["audit"]
    assert got["healthz_failed"] == 200 and got["404"] == 404 and got["stopped"]
    # every metric the reference exports, under the same name
    assert ref_names <= got_names, sorted(ref_names - got_names)
    assert {"repro_health_ready", "repro_health_live", "repro_health_checks_total",
            "repro_flushes_total"} <= got_names


def _quorum_and_debug(pkg, tmp_path):
    """tests/test_cluster.py's quorum case: a lagging follower degrades, a
    dead minority degrades, a dead majority fails, rejoins restore ready;
    ``/readyz`` and ``/debug`` carry the cluster over HTTP."""
    rs = replica_set(pkg, tmp_path / "c", n=40, deg=2.0, seed=26, n_replicas=3,
                     checkpoint_every=1)
    stream = batches(40, 2.0, 26, 3, 13)
    for arrays in stream[:2]:
        rs.update(pkg.updates.UpdateBatch(*arrays))
    rs.sync()
    mon = pkg.serve.HealthMonitor(cluster=rs, max_lag_versions=0)
    out = [mon.check()["state"]]
    rs.update(pkg.updates.UpdateBatch(*stream[2]))
    rs.wal.sync()
    rs.replicas["r0"].catch_up()
    rs.replicas["r1"].catch_up()
    rs.replicas["r2"].poll()
    rep = mon.check()
    out += [rep["state"], rep["failing"]]
    rs.replicas["r2"].flip()
    out.append(mon.check()["state"])
    rs.kill("r2")
    rep = mon.check()
    out += [rep["state"], rep["failing"], rep["checks"]["quorum"]["detail"]]
    rs.kill("r1")
    rep = mon.check()
    out += [rep["state"], rep["failing"], rep["checks"]["quorum"]["value"]]
    rs.rejoin("r1")
    rs.rejoin("r2")
    rs.sync()
    out.append(mon.check()["state"])
    assert mon in pkg.serve.all_monitors()
    with pkg.serve.HealthServer(mon) as hs:
        body = json.loads(urllib.request.urlopen(hs.url + "/readyz", timeout=5).read())
        dbg = json.loads(urllib.request.urlopen(hs.url + "/debug", timeout=5).read())
    cluster = dbg["cluster"]
    out += [body, cluster["checkpoints"]["last_version"] == rs.version,
            {name: (row["alive"], sorted(row["cursor"]), row["published_version"],
                    row["restored_from_version"])
             for name, row in cluster["replicas"].items()},
            dbg["service"]["plan_footprint_bytes"], sorted(dbg)]
    rs.close()
    return out


def test_health_quorum_and_debug_match_reference(tmp_path):
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    ref = _quorum_and_debug(REF, tmp_path / "ref")
    got = _quorum_and_debug(PORT, tmp_path / "port")
    assert got == ref
    assert got[0] == "ready" and got[1] == "degraded"
    assert any(k.startswith("replica_lag") for k in got[2]) and got[3] == "ready"
    assert got[4] == "degraded" and "fleet" in got[5] and "dead: ['r2']" in got[6]
    assert got[7] == "failed" and "quorum" in got[8] and got[9] == {"live": 1, "total": 3}
    assert got[10] == "ready" and got[11]["ready"] is True and got[12]
    assert all(row[0] for row in got[13].values())


def test_health_monitor_registered_in_the_ports_own_set():
    """Port monitors register in the port's weak set, not the reference's
    (the test suite's failure hook dumps the reference's)."""
    mon = PORT.serve.HealthMonitor()
    assert mon in PORT.serve.all_monitors()
    assert all(m is not mon for m in REF.serve.all_monitors())
    assert mon.report()["state"] == "ready"  # report() runs a first check
    flusher = mon.report()["checks"]["flusher"]
    assert flusher["ok"] and "synchronous" in flusher["detail"]


def test_dead_flusher_fails_liveness():
    """A started flusher thread that died (here: its loop returns at once)
    is a hard failure, and the monitor says so."""
    g = int_graph(PORT, 40, 2.0, 3)
    svc = PORT.serve.AsyncWindowService(PORT.api.Session(g, specs(PORT), torch_device="cpu"))
    svc._flusher_loop = lambda: None
    svc.start()
    svc._thread.join(timeout=30)
    rep = PORT.serve.HealthMonitor(service=svc).check()
    assert rep["live"] is False and rep["state"] == "failed"
    assert rep["checks"]["flusher"]["detail"] == "flusher thread died"

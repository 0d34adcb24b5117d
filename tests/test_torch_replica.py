"""Read replicas, port vs reference, on the CPU.

A follower tails a leader's write-ahead log across the packages, both
ways: a port ``ReadReplica`` (``torch_device="cpu"``) tails a log the
reference's ``AsyncWindowService`` wrote, and a reference replica tails
the port writer's, single-file and segmented.  At every published version
the follower serves bit for bit what the leader served there, and it
verifies the leader's digest records with no divergence (the k-hop plan
digest included; the topological plan digest left out, since the port's
I-Index plan also holds the chain layout).  The reference's own replica
cases (pinning, ``poll(upto_version=)``, lag, checkpoint rejoin,
truncation, divergence) run through both packages and agree.
"""

import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.core.api as r_api  # noqa: E402
import repro.obs as r_obs  # noqa: E402
import repro.obs.audit as r_audit  # noqa: E402
import repro.serve as r_serve  # noqa: E402
import repro.serve.checkpoint as r_ckpt  # noqa: E402
import repro.core.windows as r_windows  # noqa: E402
from repro.core import updates as r_updates  # noqa: E402
from repro.graphs import generators as r_gen  # noqa: E402

import repro_torch.core.api as p_api  # noqa: E402
import repro_torch.obs as p_obs  # noqa: E402
import repro_torch.obs.audit as p_audit  # noqa: E402
import repro_torch.serve as p_serve  # noqa: E402
import repro_torch.serve.checkpoint as p_ckpt  # noqa: E402
import repro_torch.core.windows as p_windows  # noqa: E402
from repro_torch.core import updates as p_updates  # noqa: E402
from repro_torch.graphs import generators as p_gen  # noqa: E402

from test_torch_engine_iindex import dag_batch  # noqa: E402
from test_torch_service import _same, khop_batch  # noqa: E402

KHOP_AGGS = ("sum", "count", "avg", "min", "max")
TOPO_AGGS = ("sum", "count", "min", "max")


def _pkg(api, obs, audit, serve, ckpt, updates, gen, windows, **session_kw):
    return types.SimpleNamespace(api=api, obs=obs, audit=audit, serve=serve, ckpt=ckpt,
                                 updates=updates, gen=gen, windows=windows,
                                 session_kw=session_kw)


REF = _pkg(r_api, r_obs, r_audit, r_serve, r_ckpt, r_updates, r_gen, r_windows,
           use_pallas=False)
PORT = _pkg(p_api, p_obs, p_audit, p_serve, p_ckpt, p_updates, p_gen, p_windows,
            torch_device="cpu")
PKGS = {"ref": REF, "port": PORT}


@pytest.fixture(autouse=True)
def _obs_off():
    for pkg in PKGS.values():
        pkg.obs.disable()
    yield
    for pkg in PKGS.values():
        pkg.obs.disable()


def graph(pkg, kind, n=300):
    if kind == "khop":
        return pkg.gen.with_random_attrs(pkg.gen.erdos_renyi(n, 3.0, seed=5), seed=6)
    return pkg.gen.with_random_attrs(pkg.gen.random_dag(n, 4.0, seed=5, locality=40), seed=6)


def specs(pkg, kind):
    if kind == "khop":
        return [pkg.api.QuerySpec(pkg.api.KHopWindow(2), a) for a in KHOP_AGGS]
    return [pkg.api.QuerySpec(pkg.api.TopologicalWindow(), a) for a in TOPO_AGGS]


def stream(kind, count, seed=17, n=300):
    """A fixed stream of (src, dst, op) arrays drawn against the evolving
    port graph (both packages' graphs evolve identically)."""
    g = graph(PORT, kind, n)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        arrays = khop_batch(g, rng) if kind == "khop" else dag_batch(g, rng, 6, 2, tail=0.1)
        out.append(arrays)
        g = p_updates.apply_batch(g, p_updates.UpdateBatch(*arrays))
    return out


def session(pkg, kind, **kw):
    return pkg.api.Session(graph(pkg, kind), specs(pkg, kind), **pkg.session_kw, **kw)


def lead(pkg, kind, wal, batches):
    """Stream ``batches`` through ``pkg``'s ``AsyncWindowService`` writing
    ``wal`` (digest records on); returns what it served at each version
    (every spec's full vector) and the closed service."""
    svc = pkg.serve.AsyncWindowService(session(pkg, kind), bucket=4, wal=wal,
                                       wal_digests=True)
    served = {0: [svc.query(si) for si in range(len(svc.session.compiled.specs))]}
    for arrays in batches:
        svc.update(pkg.updates.UpdateBatch(*arrays))
        served[svc.version] = [svc.query(si) for si in range(len(svc.session.compiled.specs))]
    svc.close()
    return served, svc


def wal_target(pkg, layout, tmp_path):
    if layout == "file":
        return str(tmp_path / "leader.wal"), str(tmp_path / "leader.wal")
    d = str(tmp_path / "wal")
    return pkg.serve.SegmentedWriteAheadLog(d, rotate_records=2), d


# ---------------------------------------------------------------------- #
#  Cross-package replication, both ways
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("layout", ["file", "segmented"])
@pytest.mark.parametrize("kind", ["khop", "topo"])
@pytest.mark.parametrize("leader,follower", [("ref", "port"), ("port", "ref")])
def test_follower_of_the_other_package_serves_the_leaders_versions(
        tmp_path, leader, follower, kind, layout):
    lpkg, fpkg = PKGS[leader], PKGS[follower]
    batches = stream(kind, 5)
    wal, path = wal_target(lpkg, layout, tmp_path)
    served, svc = lead(lpkg, kind, wal, batches)
    rep = fpkg.serve.ReadReplica(graph(fpkg, kind), specs(fpkg, kind), path,
                                 check_plan_digest=kind == "khop", name="f",
                                 **fpkg.session_kw)
    for si, want in enumerate(served[0]):
        assert _same(rep.query(si), want), (0, si)
    for v in range(1, len(batches) + 1):
        assert rep.poll(upto_version=v) == 1
        assert rep.flip() == v and rep.version == v
        for si, want in enumerate(served[v]):
            assert _same(rep.query(si), want), (v, si)
    assert rep.digest_checks == len(batches) and rep.divergence is None
    assert rep.stats["diverged"] is False and rep.lag["behind_bytes"] == 0
    assert rep.session.digest()["graph_crc"] == svc.session.digest()["graph_crc"]
    if kind == "khop":  # the DBIndex plans are array-equal across the packages
        assert rep.session.digest() == svc.session.digest()


# ---------------------------------------------------------------------- #
#  The reference's replica cases, through both packages
# ---------------------------------------------------------------------- #
def _lag_pinned_then_catch_up(pkg, tmp_path):
    """tests/test_wal_recovery.py: the pinned follower serves its version
    while the leader streams ahead; catch_up + flip publishes the leader's
    exact vectors."""
    batches = stream("khop", 5, seed=62)
    path = str(tmp_path / "svc.wal")
    leader = pkg.serve.AsyncWindowService(session(pkg, "khop"), wal=path)
    replica = pkg.serve.ReadReplica(graph(pkg, "khop"), specs(pkg, "khop"), path,
                                    **pkg.session_kw)
    v0 = replica.query(0)
    for arrays in batches[:4]:
        leader.update(pkg.updates.UpdateBatch(*arrays))
    leader.wal.sync()
    out = [replica.poll(), replica.version, replica.head_version,
           replica.lag["unpublished_versions"], _same(replica.query(0), v0)]
    replica.flip()
    out += [replica.version] + [_same(replica.query(si), leader.query(si)) for si in (0, 3)]
    leader.update(pkg.updates.UpdateBatch(*batches[4]))
    leader.wal.sync()
    out += [replica.catch_up(), _same(replica.query(0), leader.query(0)),
            replica.lag["behind_bytes"], replica.query(4).tobytes()]
    leader.close()
    return out


def _upto_version_holds_then_resumes(pkg, tmp_path):
    batches = stream("khop", 6, seed=72)
    path = str(tmp_path / "svc.wal")
    live = session(pkg, "khop")
    with pkg.serve.WriteAheadLog(path) as wal:
        for arrays in batches:
            b = pkg.updates.UpdateBatch(*arrays)
            wal.append(b)
            live.update(b)
    replica = pkg.serve.ReadReplica(graph(pkg, "khop"), specs(pkg, "khop"), path,
                                    **pkg.session_kw)
    out = [replica.poll(upto_version=3), replica.head_version, replica.cursor["offset"],
           replica.poll(), replica.head_version]
    replica.flip()
    return out + [_same(replica.query(0), np.asarray(live.run()[0]))]


def _segments_cursor(pkg, tmp_path):
    """tests/test_cluster.py: tail a rotating log by (segment, offset),
    hold at a point-in-time version, resume exactly there."""
    batches = stream("khop", 6, seed=5)
    leader = session(pkg, "khop")
    wal = pkg.serve.SegmentedWriteAheadLog(tmp_path / "wal", rotate_records=2)
    rep = pkg.serve.ReadReplica(graph(pkg, "khop"), specs(pkg, "khop"), tmp_path / "wal",
                                **pkg.session_kw)
    out = [dict(rep.cursor)]
    for arrays in batches[:3]:
        b = pkg.updates.UpdateBatch(*arrays)
        wal.append(b)
        leader.update(b)
    wal.sync()
    out += [rep.catch_up(), rep.version, rep.cursor["segment"] == wal.active_base,
            dict(rep.cursor)]
    for arrays in batches[3:]:
        b = pkg.updates.UpdateBatch(*arrays)
        wal.append(b)
        leader.update(b)
    wal.sync()
    rep.poll(upto_version=5)
    rep.flip()
    out += [rep.version, dict(rep.cursor), rep.catch_up(), rep.version, rep.lag]
    out += [_same(x, y) for x, y in zip(leader.run(), rep.session.run())]
    wal.close()
    return out


def _survives_truncation(pkg, tmp_path):
    """Truncation deletes a sealed segment a caught-up replica's cursor
    still points into: it re-seeks from its head; a replica genuinely
    behind the truncation raises ``WalTruncatedError``."""
    batches = stream("khop", 6, seed=6)
    wal = pkg.serve.SegmentedWriteAheadLog(tmp_path / "wal", rotate_records=2)
    rep = pkg.serve.ReadReplica(graph(pkg, "khop"), specs(pkg, "khop"), tmp_path / "wal",
                                **pkg.session_kw)
    lagger = pkg.serve.ReadReplica(graph(pkg, "khop"), specs(pkg, "khop"), tmp_path / "wal",
                                   name="lagger", **pkg.session_kw)
    for arrays in batches[:4]:
        wal.append(pkg.updates.UpdateBatch(*arrays))
    wal.sync()
    out = [rep.catch_up(), lagger.poll(upto_version=1)]
    out.append([b for b, _ in wal.truncate_upto(4)])
    for arrays in batches[4:]:
        wal.append(pkg.updates.UpdateBatch(*arrays))
    wal.sync()
    out += [rep.catch_up(), rep.version]
    with pytest.raises(pkg.serve.WalTruncatedError, match="history"):
        lagger.poll()
    wal.close()
    return out


def _rejoin_from_checkpoint(pkg, tmp_path):
    """Checkpoint + tail rejoin after the full history was truncated:
    bitwise a fresh session at the head, graph digests verified along the
    tail with the plan component off."""
    batches = stream("khop", 6, seed=7)
    leader = session(pkg, "khop")
    wal = pkg.serve.SegmentedWriteAheadLog(tmp_path / "wal", rotate_records=2)
    for i, arrays in enumerate(batches):
        b = pkg.updates.UpdateBatch(*arrays)
        v = wal.append(b)
        leader.update(b)
        wal.append_digest(leader.digest(), version=v)
        if i == 3:
            pkg.ckpt.save_checkpoint(leader, tmp_path / "ck")
    wal.sync()
    wal.truncate_upto(4)
    rep = pkg.serve.ReadReplica.from_checkpoint(
        specs(pkg, "khop"), tmp_path / "wal", tmp_path / "ck", name="back",
        **pkg.session_kw)
    out = [rep.restored_from_version, rep.check_plan_digest, rep.catch_up(), rep.version,
           rep.digest_checks, rep.divergence is None]
    fresh = pkg.api.Session(leader.graph, specs(pkg, "khop"), **pkg.session_kw)
    out += [_same(x, y) for x, y in zip(fresh.run(), rep.session.run())]
    out += [_same(x, y) for x, y in zip(leader.run(), rep.session.run())]
    wal.close()
    return out


def _cursor_below_oldest_segment(pkg, tmp_path):
    """A cursor pointing below the oldest retained segment raises."""
    batches = stream("khop", 7, seed=8)
    wal = pkg.serve.SegmentedWriteAheadLog(tmp_path / "wal", rotate_records=2)
    for arrays in batches:
        wal.append(pkg.updates.UpdateBatch(*arrays))
    wal.sync()
    removed = [b for b, _ in wal.truncate_upto(4)]
    rep = pkg.serve.ReadReplica(graph(pkg, "khop"), specs(pkg, "khop"), tmp_path / "wal",
                                **pkg.session_kw)
    with pytest.raises(pkg.serve.WalTruncatedError):
        rep.poll()
    with pytest.raises(pkg.serve.WalTruncatedError):
        pkg.serve.scan_segmented_entries(tmp_path / "wal", (1, 8))
    wal.close()
    return [removed, rep.head_version, dict(rep.cursor)]


def _divergent_base_graph(pkg, tmp_path):
    """The reference's divergence case: a follower whose base graph differs
    in one attribute value quarantines the FIRST bad version, at the WAL
    byte offset of the digest record it disagreed with."""
    batches = stream("khop", 3, seed=0)
    path = str(tmp_path / "leader.wal")
    lead(pkg, "khop", path, batches)
    g = graph(pkg, "khop")
    vals = np.asarray(g.attrs["val"]).copy()
    vals[0] += 1.0
    reg = pkg.obs.MetricsRegistry()
    rep = pkg.serve.ReadReplica(g.with_attr("val", vals), specs(pkg, "khop"), path, obs=reg,
                                **pkg.session_kw)
    rep.catch_up()
    f = rep.divergence
    entry = [e for e in pkg.serve.scan_wal_entries(path)[0] if e["offset"] == f.wal_offset]
    return [f.source, f.version, f.wal_offset, f.detail, rep.digest_checks,
            [(e["kind"], e["version"]) for e in entry],
            reg.snapshot()["repro_replica_divergence_total"]["values"][0]["value"],
            any(e["event"] == "divergence" for e in rep.service.flight.dump())]


def _corrupted_digest_record(pkg, tmp_path):
    """A digest record whose ``graph_crc`` is off by one bit (a leader
    that stamped a wrong digest): the follower quarantines exactly that
    version at that record's byte offset, and later clean records do not
    replace the finding."""
    batches = stream("khop", 4, seed=9)
    leader = session(pkg, "khop")
    wal = pkg.serve.SegmentedWriteAheadLog(tmp_path / "wal", rotate_records=2)
    for arrays in batches:
        b = pkg.updates.UpdateBatch(*arrays)
        v = wal.append(b)
        leader.update(b)
        d = leader.digest()
        if v == 2:
            d = dict(d, graph_crc=d["graph_crc"] ^ 1)
        wal.append_digest(d, version=v)
    wal.sync()
    rep = pkg.serve.ReadReplica(graph(pkg, "khop"), specs(pkg, "khop"), tmp_path / "wal",
                                **pkg.session_kw)
    rep.catch_up()
    f = rep.divergence
    (bad,) = [e for e in pkg.serve.scan_segmented_entries(tmp_path / "wal")[0]
              if e["kind"] == "digest" and e["version"] == 2]
    wal.close()
    return [f.source, f.version, f.wal_offset == bad["offset"], f.wal_offset,
            "graph_crc" in f.detail, rep.digest_checks, rep.version]


CASES = {"lag_pinned_then_catch_up": _lag_pinned_then_catch_up,
         "upto_version_holds_then_resumes": _upto_version_holds_then_resumes,
         "segments_cursor": _segments_cursor,
         "survives_truncation": _survives_truncation,
         "rejoin_from_checkpoint": _rejoin_from_checkpoint,
         "cursor_below_oldest_segment": _cursor_below_oldest_segment,
         "divergent_base_graph": _divergent_base_graph,
         "corrupted_digest_record": _corrupted_digest_record}

# what each case must show, beyond agreeing with the reference
EXPECT = {
    "lag_pinned_then_catch_up": lambda o: o[:5] == [4, 0, 4, 4, True] and o[5:8] == [4, True, True]
    and o[8:11] == [1, True, 0],
    "upto_version_holds_then_resumes": lambda o: o[0] == 3 and o[1] == 3 and o[3:] == [3, 6, True],
    "segments_cursor": lambda o: o[1:4] == [3, 3, True] and o[5] == 5 and o[7:9] == [1, 6]
    and all(o[10:]),
    "survives_truncation": lambda o: o == [4, 1, [1], 2, 6],
    "rejoin_from_checkpoint": lambda o: o[:6] == [4, False, 2, 6, 2, True] and all(o[6:]),
    "cursor_below_oldest_segment": lambda o: o[0] == [1, 3] and o[1] == 0,
    "divergent_base_graph": lambda o: o[0] == "digest" and o[1] == 1 and o[2] > 0
    and "graph_crc" in o[3] and o[4] == 3 and o[5] == [("digest", 1)] and o[6] == 1.0 and o[7],
    "corrupted_digest_record": lambda o: o[:3] == ["digest", 2, True] and o[4:] == [True, 4, 4],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_replica_case_matches_reference(tmp_path, case):
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    ref = CASES[case](REF, tmp_path / "ref")
    got = CASES[case](PORT, tmp_path / "port")
    assert got == ref
    assert EXPECT[case](got), got


def test_replica_metrics_are_labelled_and_resolved_at_call_time(tmp_path):
    """A replica built while observability is off lands its per-replica
    labelled metrics in the registry enabled afterwards."""
    batches = stream("khop", 2, seed=12)
    path = str(tmp_path / "leader.wal")
    lead(PORT, "khop", path, batches)
    rep = p_serve.ReadReplica(graph(PORT, "khop"), specs(PORT, "khop"), path,
                              name="r7", torch_device="cpu")
    reg, _ = p_obs.enable()
    assert rep.catch_up() == 2
    rep.lag
    prom = reg.prometheus()
    for name in ("repro_replica_polls_total", "repro_replica_records_total",
                 "repro_replica_digest_checks_total", "repro_replica_lag_bytes",
                 "repro_replica_lag_versions"):
        assert f'{name}{{replica="r7"}}' in prom, name
    assert 'repro_replica_records_total{replica="r7"} 2' in prom


def test_tail_daemon_catches_up_and_stops(tmp_path):
    batches = stream("khop", 3, seed=13)
    wal = p_serve.SegmentedWriteAheadLog(tmp_path / "wal", rotate_records=2)
    leader = session(PORT, "khop")
    rep = p_serve.ReadReplica(graph(PORT, "khop"), specs(PORT, "khop"), tmp_path / "wal",
                              torch_device="cpu").start_tailing(interval_s=0.01)
    assert rep.tailing
    for arrays in batches:
        b = p_updates.UpdateBatch(*arrays)
        wal.append(b)
        leader.update(b)
    wal.sync()
    import time

    deadline = time.monotonic() + 60
    while rep.version < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    rep.kill()
    assert not rep.tailing and not rep.alive and rep.version == 3
    for x, y in zip(leader.run(), rep.session.run()):
        assert _same(x, y)
    assert os.path.isdir(rep.path) and rep.cursor["segment"] == wal.active_base
    wal.close()

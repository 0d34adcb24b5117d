"""Content digests, the shadow oracle and the WAL scrubber, port vs
reference, on the CPU.

``graph_crc`` and the DBIndex ``plan_crc`` fold the same named arrays with
the same dtype strings as the reference's (a tensor folds as its host NumPy
copy), so they are equal wherever the plans are array-equal — at build and
through a patched stream.  The I-Index plan's digest covers the port's own
arrays (the chain layout included) and is held port to port: deterministic
and sensitive to one flipped entry.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.obs.audit as r_audit  # noqa: E402
import repro.serve.wal as r_wal  # noqa: E402

import repro_torch.obs.audit as p_audit  # noqa: E402
import repro_torch.serve.wal as p_wal  # noqa: E402

from test_torch_service import (  # noqa: E402
    PORT,
    REF,
    _same,
    make_session,
    next_batch,
)
from test_torch_wal import _lead  # noqa: E402


def _state(sess):
    (state,) = sess._states.values()
    return state


def test_graph_and_dbindex_plan_crc_equal_reference_through_a_stream():
    _, rs = make_session(REF, "khop")
    _, ps = make_session(PORT, "khop")
    rng = np.random.default_rng(9)
    for step in range(4):
        assert p_audit.graph_crc(ps.graph) == r_audit.graph_crc(rs.graph), step
        assert p_audit.plan_crc(_state(ps).plan) == r_audit.plan_crc(_state(rs).plan), step
        assert ps.digest(include_results=True) == rs.digest(include_results=True), step
        arrays = next_batch("khop", ps.graph, rng)
        rs.update(REF.batch(arrays))
        ps.update(PORT.batch(arrays))


@pytest.mark.parametrize("kind", ["khop", "topo"])
def test_named_plan_arrays_are_what_array_nbytes_counts(kind):
    _, ps = make_session(PORT, kind)
    plan = _state(ps).plan
    named = p_audit.named_plan_arrays(plan)
    assert named.keys() == plan.array_nbytes().keys()
    for key, t in named.items():
        assert isinstance(t, torch.Tensor)
        assert plan.array_nbytes()[key] == t.numel() * t.element_size(), key
    if kind == "topo":
        assert {"order", "level_ptr", "chains.vertices", "chains.ptr",
                "chains.head_parent"} <= named.keys()


def test_iindex_plan_digest_deterministic_and_sensitive():
    """Held port to port: two sessions built alike digest alike; one
    flipped entry of any array — the chain layout's too — moves the plan
    digest."""
    _, s1 = make_session(PORT, "topo")
    _, s2 = make_session(PORT, "topo")
    d1 = s1.digest(include_results=True)
    assert d1 == s2.digest(include_results=True)
    assert {"version", "graph_crc", "plan_crc", "result_crc"} <= set(d1)
    named = p_audit.named_plan_arrays(_state(s2).plan)
    for key in ("chains.vertices", "level", "wd_plan.gather_padded"):
        t = named[key]
        t.view(-1)[1] += 1
        assert s2.digest()["plan_crc"] != d1["plan_crc"], key
        t.view(-1)[1] -= 1
    assert s2.digest()["plan_crc"] == d1["plan_crc"]
    ok, detail = p_audit.digests_match(d1, dict(d1, plan_crc=d1["plan_crc"] ^ 1))
    assert not ok and "plan_crc" in detail
    assert p_audit.digests_match(d1, dict(d1, plan_crc=0), check_plans=False)[0]


@pytest.mark.parametrize("kind", ["khop", "topo"])
def test_oracle_single_matches_reference(kind):
    g, ps = make_session(PORT, kind)
    rg, rs = make_session(REF, kind)
    window, rwindow = ps.compiled.groups[0].window, rs.compiled.groups[0].window
    vals = np.asarray(g.attrs["val"], np.float64)
    for agg in ("sum", "min", "avg", "count"):
        for v in (0, 7, 311, g.n - 1):
            got = p_audit.oracle_single(g, window, vals, agg, v, dtype=np.float32)
            want = r_audit.oracle_single(rg, rwindow, vals, agg, v, dtype=np.float32)
            assert _same(got, want), (agg, v)


def test_shadow_auditor_clean_then_detects_a_corrupted_vector():
    _, ps = make_session(PORT, "khop")
    svc = PORT.ws.WindowService(ps, bucket=4)
    auditor = p_audit.ShadowAuditor(sample_rate=1.0, full_row_rate=1.0)
    svc.attach_auditor(auditor)
    with auditor:
        for v in range(0, ps.graph.n, 97):
            svc.query(0, vertex=v)
        svc.query(3)
        assert auditor.drain()
        assert auditor.audited > 0 and auditor.mismatches == 0
        gi = ps.compiled.spec_slots[0][0]
        ps._result_cache._entries[gi]["vectors"]["sum"][5] += 1.0
        svc.query(0, vertex=5)
        assert auditor.drain()
    assert auditor.mismatches == 1
    (f,) = auditor.findings
    assert f.source == "oracle" and f.vertex == 5 and f.version == 0


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_scrubber_finds_a_flipped_sealed_byte(tmp_path, writer):
    """Either package's log, scrubbed by the port: clean sweeps find
    nothing; one flipped payload byte of the version-2 record is reported
    once, at that record's offset."""
    path = str(tmp_path / "leader.wal")
    _lead({"ref": REF, "port": PORT}[writer], path)
    scrub = p_audit.WalScrubber(path)
    assert scrub.scrub_once() == [] and scrub.records_verified == 10
    target = [e for e in p_wal.scan_wal_entries(path)[0] if e["kind"] == "batch"][1]
    with open(path, "r+b") as f:
        f.seek(target["offset"] + p_wal._REC_HDR.size + 3)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0xFF]))
    (finding,) = scrub.scrub_once()
    assert finding.source == "scrub" and finding.version == 2
    assert finding.wal_offset == target["offset"]
    assert scrub.scrub_once() == [] and scrub.corruptions == 1
    # the reference's scrubber agrees on the damaged file
    (rf,) = r_audit.WalScrubber(path).scrub_once()
    assert (rf.version, rf.wal_offset) == (finding.version, finding.wal_offset)
    assert [v for v, _ in r_wal.read_wal_records(path)[0]] == [1]

"""Serving over a sharded session (``Session(mesh=...)``) in the port, on
the CPU over gloo.

The reference's sharded serving cases (``tests/test_service.py:296-448``)
and its composite sharded stream (``tests/test_window_algebra.py:382``)
run here at world size 1, in the test's process, held against the
set-evaluation oracle (``brute_force``) bit for bit: attributes are small
integers, so every float32 partial is exact.  The multi-device service
runs as two spawned gloo ranks of this file (``python
tests/test_torch_sharded_service.py service <rank> 2 <store> <out>``):
rank 0 leads (``ShardedSession.lead``) and serves a ``WindowService`` and
an ``AsyncWindowService`` with its flusher thread, rank 1 follows
(``ShardedSession.follow``); every ticket is bitwise the world-1 answer
and the single-host session's at the ticket's version, and both ranks
exit.
"""

import inspect
import os
import pathlib
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from test_torch_sharded import _init, _mixed  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
N_SERVICE = 150
ASYNC_TICKETS = 24
SPAWN_TIMEOUT_S = 150


# ---------------------------------------------------------------------- #
#  scenarios shared by the test process and the spawned ranks
# ---------------------------------------------------------------------- #
def _int_graph(n, deg, seed, lo=0, hi=50):
    """ER graph with small-integer ``val`` attributes (the reference's
    ``int_graph``)."""
    from repro_torch.graphs.generators import erdos_renyi

    g = erdos_renyi(n, deg, directed=False, seed=seed)
    vals = np.random.default_rng(seed + 1).integers(lo, hi, g.n)
    return g.with_attr("val", vals.astype(np.float64))


def _service_pair(mesh, torch_device="cpu"):
    """The reference's multi-device service case: ER n = 150, KHop(1) sum
    and min, headroom 1.0; a ``ShardedSession`` on ``mesh`` and a
    single-host ``Session`` on the same graph (``mesh=None``: two
    single-host sessions)."""
    from repro_torch.core.api import QuerySpec, Session
    from repro_torch.graphs.generators import erdos_renyi

    rng = np.random.default_rng(71)
    g = erdos_renyi(N_SERVICE, 3.0, directed=False, seed=71)
    g = g.with_attr("val", rng.integers(0, 50, g.n).astype(np.float64))
    specs = [QuerySpec(("khop", 1), a) for a in ("sum", "min")]
    kw = dict(plan_headroom=1.0, torch_device=torch_device)
    return Session(g, specs, mesh=mesh, **kw), Session(g, specs, **kw), rng


def _service_scenario(sess, rng) -> list:
    """The reference's scenario: a 3-ticket explicit-values flush in one
    coalesced sharded launch, then 3 insert batches, each followed by
    point reads of both specs at vertices 1, 7 and 42 through the
    affected-owner cache.  Returns every ticket's result, in order."""
    from repro_torch.core.updates import UpdateBatch
    from repro_torch.serve import WindowService

    svc = WindowService(sess, bucket=4)
    g = sess.graph
    vb = rng.integers(0, 50, size=(3, g.n)).astype(np.float64)
    tickets = [svc.submit(0, values=vb[i]) for i in range(3)]
    svc.flush()
    assert svc.batched_launches == 1, svc.batched_launches
    out = [np.asarray(t.result) for t in tickets]
    for _ in range(3):
        s = rng.integers(0, g.n, 4).astype(np.int32)
        d = rng.integers(0, g.n, 4).astype(np.int32)
        ok = (s != d) & ~svc.session.graph.contains_edges(s, d)
        svc.update(UpdateBatch.inserts(s[ok], d[ok]))
        for si in range(2):
            for v in (1, 7, 42):
                out.append(np.asarray(svc.query(si, vertex=v)))
    assert svc.point_hits > 0
    return out, vb


def _async_scenario(sess, host, seed) -> int:
    """``AsyncWindowService`` with its flusher thread over ``sess`` while
    3 update batches land: a client thread submits point and
    explicit-values reads; every ticket bitwise ``host`` (a single-host
    session on the same stream) at the ticket's version.  Returns the
    tickets checked."""
    from repro_torch.serve import AsyncWindowService

    rng = np.random.default_rng(seed)
    views = {host.version: host.snapshot()}
    tickets = []
    svc = AsyncWindowService(sess, bucket=4).start()
    n = sess.graph.n

    def client():
        crng = np.random.default_rng(seed + 1)
        for i in range(ASYNC_TICKETS):
            values = (crng.integers(0, 50, n).astype(np.float64) if i % 3 == 0 else None)
            spec, vertex = i % 2, int(crng.integers(0, n))
            tickets.append((svc.submit(spec, vertex=vertex, values=values), spec, vertex,
                            values))
            time.sleep(0.002)

    th = threading.Thread(target=client)
    th.start()
    try:
        for _ in range(3):
            batch = _mixed(host.graph, rng, 3, 2)
            svc.update(batch)
            host.update(batch)
            views[host.version] = host.snapshot()
            time.sleep(0.01)
    finally:
        th.join(timeout=60)
        svc.stop(drain=True)
    assert not th.is_alive() and len(tickets) == ASYNC_TICKETS
    for t, spec, vertex, values in tickets:
        got = t.get(timeout=30)
        want = views[t.version].run(values)[spec][vertex]
        assert np.asarray(got).tobytes() == np.asarray(want).tobytes(), (spec, vertex, t.version)
    return len(tickets)


# ---------------------------------------------------------------------- #
#  spawned ranks
# ---------------------------------------------------------------------- #
def _w_service(rank, world, store, out):
    """World 2: rank 0 leads the reference's service scenario and the
    async one, rank 1 follows; rank 0 saves its tickets.  The sessions
    live on ``SERVICE_DEVICE`` (``cuda``: both ranks on ``cuda:0``, gloo
    carrying the card's tensors)."""
    import torch.distributed as dist

    dev = os.environ.get("SERVICE_DEVICE", "cpu")
    if dev == "cuda":
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    mesh = _init(rank, world, store)
    report = []
    for scenario in ("service", "async"):  # a fresh pair of sessions each
        sess, host, rng = _service_pair(mesh, dev)
        if rank == 0:
            sess.lead()
            try:
                if scenario == "service":
                    results, _ = _service_scenario(sess, rng)
                    np.savez(f"{out}.{rank}.npz", *results)
                else:
                    report.append(_async_scenario(sess, host, 72))
            finally:
                sess.stop_followers()
        else:
            report.append(sess.follow())
    with open(f"{out}.{rank}.txt", "w") as f:
        f.write(" ".join(str(r) for r in report))
    dist.destroy_process_group()


def _w_diverge(rank, world, store, out):
    """World 2: rank 0 leads and sends one query record at a version no
    rank holds (a follower that left the leader's order), then leads no
    more; rank 1 follows and must fail with the replay's error.  Rank 0
    sends no stop record: the follower is gone."""
    import torch.distributed as dist

    mesh = _init(rank, world, store)
    sess, _, _ = _service_pair(mesh)
    if rank == 0:
        sess.lead()
        sess._ops.send(("group", 0, sess.version + 5, None))
        sess._ops = None
        dist.destroy_process_group()
        return
    sess.follow()  # raises: no view at that version


_WORKERS = {"service": _w_service, "diverge": _w_diverge}


def _spawn(worker: str, world: int, tmp_path, ok=None, **env_extra) -> list:
    """``world`` ranks of ``worker``, spawned processes of this file, each
    with a timeout (a hang fails the test); every rank must exit with 0,
    or fail where ``ok[rank]`` is False.  Returns their output path stems
    and each rank's standard error."""
    import subprocess

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1",
           **env_extra}
    args = [str(tmp_path / "store"), str(tmp_path / "out")]
    procs = [subprocess.Popen([sys.executable, __file__, worker, str(r), str(world), *args],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env, cwd=ROOT) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=SPAWN_TIMEOUT_S))
    finally:
        for p in procs:
            p.kill()
    for r, (p, (o, e)) in enumerate(zip(procs, outs)):
        assert (p.returncode == 0) == (True if ok is None else ok[r]), (
            r, p.returncode, o[-2000:] + e[-4000:])
    return [tmp_path / f"out.{r}" for r in range(world)], [e for _, e in outs]


# ---------------------------------------------------------------------- #
#  world size 1, in this process
# ---------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def mesh1(tmp_path_factory):
    import torch.distributed as dist

    mesh = _init(0, 1, str(tmp_path_factory.mktemp("gloo") / "store"))
    yield mesh
    dist.destroy_process_group()


def _brute(sess, values=None):
    from repro_torch.core.query import brute_force

    vals = sess.graph.attrs["val"] if values is None else values
    return [brute_force(sess.graph, s.window, vals, s.agg, dtype=np.float32)
            for s in sess.compiled.specs]


def test_sharded_run_many_single_launch(mesh1, monkeypatch):
    """``run_many`` serves a [B, n] bucket with one K1 call a pass for the
    whole group, no new plan signature on replay, rows bitwise per-row
    ``run()``; the service coalesces sharded traffic the same way."""
    from repro_torch.core import engine_torch as et
    from repro_torch.core.api import QuerySpec, Session
    from repro_torch.distributed.window_runtime import sharded_signature_count
    from repro_torch.serve import WindowService

    g = _int_graph(250, 3.0, seed=51)
    specs = [QuerySpec(("khop", 1), a) for a in ("sum", "min", "avg")]
    sess = Session(g, specs, mesh=mesh1, plan_headroom=1.0, torch_device="cpu")
    rng = np.random.default_rng(52)
    vb = rng.integers(0, 50, (5, g.n)).astype(np.float64)
    sess.run_many(vb)
    per_row = [sess.run(values=v) for v in vb]
    sigs = sharded_signature_count()
    calls = []
    real = et.segment_reduce_multi
    monkeypatch.setattr(et, "segment_reduce_multi",
                        lambda tp, v, m: calls.append(v.shape) or real(tp, v, m))
    outs = sess.run_many(vb)
    assert len(calls) == 2  # one K1 call a pass for the whole bucket
    assert sharded_signature_count() == sigs  # replay: no new signature
    for si in range(len(specs)):
        assert outs[si].shape == (5, g.n)
        for b in range(5):
            assert np.array_equal(outs[si][b], per_row[b][si]), (si, b)
            assert np.array_equal(per_row[b][si], _brute(sess, vb[b])[si]), (si, b)
    svc = WindowService(sess, bucket=4)
    t = svc.submit(0, vertex=3, values=vb[0])
    svc.flush()
    assert t.result == per_row[0][0][3] and svc.batched_launches == 1


def test_sharded_patch_compaction_keeps_stream_patch_only(mesh1):
    """Delete-dominated sharded stream: once the garbage-block fraction
    crosses ``compact_garbage`` the patcher re-packs pass-1 groups in place
    (no rebuild, no new signature) and answers stay exact; a batch that
    touches no block ships no pass-1 group again."""
    from repro_torch.core.api import QuerySpec, Session
    from repro_torch.core.streaming import StalenessPolicy
    from repro_torch.core.updates import UpdateBatch
    from repro_torch.distributed.window_runtime import (
        patch_sharded_plan,
        sharded_signature_count,
    )

    g = _int_graph(400, 5.0, seed=61)
    w = ("khop", 1)
    sess = Session(
        g, [QuerySpec(w, "sum"), QuerySpec(w, "count")], mesh=mesh1,
        plan_headroom=1.0, compact_garbage=0.02, torch_device="cpu",
        policy=StalenessPolicy(max_link_ratio=1e9, max_block_ratio=1e9,
                               max_garbage_ratio=0.99),
    )
    sess.run()
    sigs = sharded_signature_count()
    rng = np.random.default_rng(62)
    (state,) = sess._states.values()
    for step in range(8):
        g_cur = sess.graph
        ei = rng.choice(g_cur.n_edges, 5, replace=False)
        (rep,) = sess.update(UpdateBatch.deletes(g_cur.src[ei], g_cur.dst[ei])).values()
        assert not rep["plan_rebuilt"], (step, rep)
        assert 0 < rep["patch_bytes"] < rep["full_plan_bytes"]
        got = sess.run()
        for a, b in zip(got, _brute(sess)):
            assert np.array_equal(a, b), step
    assert state.plan.stats.get("p1_compactions", 0) >= 1
    assert state.plan.stats.get("rebuilds", 0) == 0
    assert sharded_signature_count() == sigs  # compaction never re-specialized
    assert state.plan.stats["version"] == 8  # one patch per batch
    assert len(state.plan.stats["p1_compacted_ids"]) > 0
    before = state.plan.stats.get("p1_compactions", 0)
    replayed = patch_sharded_plan(state.plan, state.index, np.empty(0, np.int64),
                                  compact_garbage=0.02)
    assert replayed.stats.get("p1_compactions", 0) == before


def test_sharded_compaction_default_fires_before_policy_rebuild():
    """The sharded compaction is shape-stable, so its default threshold
    sits below the policy's garbage rebuild threshold (else the policy's
    rebuild always wins and the patch-only promise is unreachable)."""
    from repro_torch.core.api import Session
    from repro_torch.core.streaming import StalenessPolicy
    from repro_torch.distributed.window_runtime import (
        ShardedStreamState,
        patch_sharded_plan,
    )

    thresh = StalenessPolicy().max_garbage_ratio
    for fn in (ShardedStreamState.__init__, patch_sharded_plan):
        assert inspect.signature(fn).parameters["compact_garbage"].default < thresh, fn
    # a ShardedSession's compact_garbage=None resolves to the same default
    assert inspect.signature(Session.__init__).parameters["compact_garbage"].default is None


def test_service_over_sharded_session(mesh1):
    """The reference's multi-device service case at world 1: the 3-ticket
    explicit-values flush is one coalesced sharded launch, point reads hit
    the cache across updates, every answer is the oracle's and the
    single-host session's."""
    sess, host, rng = _service_pair(mesh1)
    results, vb = _service_scenario(sess, rng)
    # replay the same stream on the single-host session and the oracle
    hrng = np.random.default_rng(71)
    hrng.integers(0, 50, host.graph.n)  # the attribute draw
    hvb = hrng.integers(0, 50, size=(3, host.graph.n)).astype(np.float64)
    assert np.array_equal(hvb, vb)
    it = iter(results)
    for i in range(3):
        got = next(it)
        assert got.tobytes() == host.run(vb[i])[0].tobytes()
        assert np.array_equal(got, _brute(host, vb[i])[0])
    from repro_torch.core.updates import UpdateBatch

    for _ in range(3):
        s = hrng.integers(0, host.graph.n, 4).astype(np.int32)
        d = hrng.integers(0, host.graph.n, 4).astype(np.int32)
        ok = (s != d) & ~host.graph.contains_edges(s, d)
        host.update(UpdateBatch.inserts(s[ok], d[ok]))
        want, oracle = host.run(), _brute(host)
        for si in range(2):
            for v in (1, 7, 42):
                got = next(it)
                assert got.tobytes() == want[si][v].tobytes(), (si, v)
                assert got == oracle[si][v]
    assert sess.version == host.version == 3


def test_async_service_over_sharded_session(mesh1):
    """The flusher thread and the writer reach the sharded session from
    two threads; every ticket is the single-host session's at its
    version.  ``lead()`` at world 1 has no follower and sends nothing."""
    sess, host, _ = _service_pair(mesh1)
    assert sess.lead() is sess and sess._ops.followers == 0
    try:
        assert _async_scenario(sess, host, 72) == ASYNC_TICKETS
    finally:
        sess.stop_followers()
    assert sess._ops is None


def test_lead_and_follow_check_their_rank(mesh1):
    """At world 1 the one rank leads; it cannot follow."""
    sess, _, _ = _service_pair(mesh1)
    with pytest.raises(ValueError):
        sess.follow()


def test_sharded_composite_session_stream_patch_only(mesh1):
    """The reference's composite stream on a 1-device mesh:
    ``Union(KHop(1, "in"), KHop(1, "out"))`` with sum, min and avg, exact
    against the oracle every third batch and after every rebuild, and
    patch-only batches never make a new plan signature; at least 10 in a
    row."""
    from repro_torch.core.api import QuerySpec, Session
    from repro_torch.core.windows import KHop, Union, canonicalize
    from repro_torch.distributed import ShardedSession
    from repro_torch.distributed.window_runtime import sharded_signature_count
    from repro_torch.graphs.generators import erdos_renyi

    rng = np.random.default_rng(33)
    g = erdos_renyi(300, 3.0, directed=True, seed=33)
    g = g.with_attr("val", rng.integers(0, 30, g.n).astype(np.float64))
    u = canonicalize(Union(KHop(1, "in"), KHop(1, "out")))
    specs = [QuerySpec(u, a) for a in ("sum", "min", "avg")]
    sess = Session(g, specs, mesh=mesh1, plan_headroom=1.0, torch_device="cpu")
    assert isinstance(sess, ShardedSession)
    sess.run()
    baseline = sharded_signature_count()
    patch_only = 0
    for step in range(30):
        reps = sess.update(_ref_mixed(sess.graph, rng, 3, 3))
        rebuilt = any(r.get("plan_rebuilt") or r["reorganized"] for r in reps.values())
        if step % 3 == 0 or rebuilt:
            for a, b in zip(sess.run(), _brute(sess)):
                assert np.array_equal(a, b), step
        if rebuilt:
            patch_only = 0
            baseline = sharded_signature_count()  # a rebuild is a new layout
        else:
            patch_only += 1
            assert sharded_signature_count() == baseline, step
        if patch_only >= 10:
            break
    assert patch_only >= 10, "never reached 10 consecutive patch-only batches"


def _ref_mixed(g, rng, n_ins, n_del):
    """``tests/test_updates.py::mixed``: random inserts (self-loops and
    existing edges dropped) and deletes of existing edges."""
    from repro_torch.core.updates import UpdateBatch

    s = rng.integers(0, g.n, n_ins).astype(np.int32)
    d = rng.integers(0, g.n, n_ins).astype(np.int32)
    ok = (s != d) & ~g.contains_edges(s, d)
    ins = UpdateBatch.inserts(s[ok], d[ok])
    ei = rng.choice(g.n_edges, min(n_del, g.n_edges), replace=False)
    return UpdateBatch.concat([ins, UpdateBatch.deletes(g.src[ei], g.dst[ei])])


# ---------------------------------------------------------------------- #
#  world size 2, spawned
# ---------------------------------------------------------------------- #
def test_world2_service_leader_follower_bitwise_world1(tmp_path, mesh1):
    """Two spawned gloo ranks: rank 0 leads the service and the async
    service, rank 1 replays every op; no hang, both ranks exit, every
    ticket of rank 0 bitwise the world-1 scenario's."""
    outs, _ = _spawn("service", 2, tmp_path)
    ranks = [np.load(f"{outs[0]}.npz")]
    got = [ranks[0][f"arr_{i}"] for i in range(len(ranks[0].files))]
    sess, _, rng = _service_pair(mesh1)
    want, _ = _service_scenario(sess, rng)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), i
    (checked,) = pathlib.Path(f"{outs[0]}.txt").read_text().split()
    replayed = [int(r) for r in pathlib.Path(f"{outs[1]}.txt").read_text().split()]
    assert int(checked) == ASYNC_TICKETS
    # the sync scenario: one flush, 3 updates, and the point reads' misses
    assert len(replayed) == 2 and min(replayed) > 3, replayed


def test_world2_follower_that_diverges_fails_not_hangs(tmp_path):
    """A record the follower cannot replay (a query at a version it does
    not hold) ends ``follow()`` with the replay's error: the follower's
    process fails with the cause, within the spawn timeout, and the leader
    exits."""
    _, errs = _spawn("diverge", 2, tmp_path, ok=[True, False])
    assert "diverged from the leader" in errs[1], errs[1][-4000:]


if __name__ == "__main__":
    _WORKERS[sys.argv[1]](int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])

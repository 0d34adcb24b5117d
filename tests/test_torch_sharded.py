"""The sharded runtime of the port (``repro_torch.distributed``) on the CPU,
over ``torch.distributed`` with gloo.

Held against the reference where the reference works on this tree (the
layout, ``plan_crc``, the one-shot sharded query and
``sharded_affected_owners``; its sharded streaming fails, R1) and, for the
stream, against the port's own single-host ``Session``, bit for bit.
Integer-valued attributes make every float32 partial exact, so order-free
comparisons are bitwise.  World size 1 runs in the test's process; world
sizes 2 and 4 run as spawned ranks of this file (``python
tests/test_torch_sharded.py <worker> <rank> <world> <store> <out>``), each
spawn with a timeout of its own and several checks.
"""

import dataclasses
import datetime
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
AGGS = ("sum", "count", "avg", "min", "max")
SPAWN_TIMEOUT_S = 150


# ---------------------------------------------------------------------- #
#  helpers shared by the test process and the spawned ranks
# ---------------------------------------------------------------------- #
def _init(rank: int, world: int, store: str, shape=None, names=("data",),
          backend="gloo"):
    """The process group (``FileStore`` rendezvous) and the mesh: a CPU
    mesh on gloo (its ranks may still hold CUDA tensors), a CUDA mesh on
    NCCL."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    # ranks of one host: rendezvous and traffic on the loopback interface
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    if backend == "nccl":  # the communicator's card, before the mesh
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=90))
    return init_device_mesh("cuda" if backend == "nccl" else "cpu", shape or (world,),
                            mesh_dim_names=names)


def _deferred():
    from repro_torch.core.streaming import StalenessPolicy

    return StalenessPolicy(max_link_ratio=float("inf"), max_block_ratio=float("inf"),
                           max_garbage_ratio=1.0)


def _mixed(g, rng, n_ins, n_del):
    """``n_ins`` new distinct edges and ``n_del`` existing ones (the
    reference's stream tests draw their batches this way)."""
    from repro_torch.core.updates import UpdateBatch

    s = rng.integers(0, g.n, n_ins * 4).astype(np.int32)
    d = rng.integers(0, g.n, n_ins * 4).astype(np.int32)
    ok = (s != d) & ~g.contains_edges(s, d)
    _, first = np.unique(g.edge_keys(s, d), return_index=True)
    pick = np.intersect1d(np.flatnonzero(ok), first)[:n_ins]
    ins = UpdateBatch.inserts(s[pick], d[pick])
    ei = rng.choice(g.n_edges, min(n_del, g.n_edges), replace=False)
    return UpdateBatch.concat([ins, UpdateBatch.deletes(g.src[ei], g.dst[ei])])


def _same(a, b, what=""):
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.shape == y.shape and np.array_equal(x, y, equal_nan=True), (what, i)


def _sharded_signatures() -> int:
    from repro_torch.distributed.window_runtime import sharded_signature_count

    return sharded_signature_count()


def _state(sess):
    (state,) = sess._states.values()
    return state


def _stream_pair(mesh, k=1, headroom=1.0, seed=21, torch_device="cpu", tile=64):
    """A ShardedSession and a single-host Session on one graph."""
    from repro_torch.core.api import QuerySpec, Session
    from repro_torch.graphs.generators import erdos_renyi, with_random_attrs

    g = with_random_attrs(erdos_renyi(400, 3.0, directed=False, seed=seed), seed=seed + 1)
    specs = [QuerySpec(("khop", k), a) for a in AGGS]
    kw = dict(tm=tile, ts=tile, plan_headroom=headroom, policy=_deferred(),
              torch_device=torch_device)
    return Session(g, specs, mesh=mesh, **kw), Session(g, specs, **kw)




def _check_stream(ss, hs, rng, batches=12, ndev=1):
    """``batches`` streamed batches: after each, ``run`` and ``run_many``
    bitwise the single-host session's, ``run_many`` rows bitwise ``run``,
    patch-only with patch bytes below the full plan's, no new sharded
    plan signature, per-slice owner counts as ``sharded_affected_owners``
    gives them."""
    from repro_torch.core.updates import apply_batch, sharded_affected_owners

    _same(ss.run(), hs.run(), "initial")
    vb0 = rng.integers(0, 100, (3, ss.graph.n)).astype(np.float64)
    _same(ss.run_many(vb0), hs.run_many(vb0), "initial run_many")
    sigs = _sharded_signatures()
    for step in range(batches):
        b = _mixed(hs.graph, rng, 4, 2)
        g2 = apply_batch(hs.graph, b)
        (rep,) = ss.update(b).values()
        hs.update(b)
        assert not rep["reorganized"], (step, rep)
        assert 0 < rep["patch_bytes"] < rep["full_plan_bytes"], (step, rep)
        _, per = sharded_affected_owners(g2, ss.compiled.groups[0].window, b, ndev,
                                         torch_device="cpu")
        assert rep["affected_per_shard"] == [p.size for p in per], step
        got = ss.run()
        _same(got, hs.run(), f"run {step}")
        vb = rng.integers(0, 100, (3, ss.graph.n)).astype(np.float64)
        many = ss.run_many(vb)
        _same(many, hs.run_many(vb), f"run_many {step}")
        for r in range(3):
            _same([m[r] for m in many], ss.run(vb[r]), f"row {r} of {step}")
        assert _sharded_signatures() == sigs, step
    assert ss.updates_applied == batches


def _check_nan(ss, hs, shard):
    """A NaN in a member of a block that ``shard`` reduces survives into
    min/max as the single-host path keeps it, also where only ``shard``
    reduced the owner's window (a bare MIN/MAX combine drops a NaN that a
    later rank holds, R8)."""
    st = _state(ss)
    member_block = np.asarray(st.index.member_block_ids, np.int64)
    on = st.plan.reducing_shard(member_block, 1) == shard
    v = int(st.index.block_members[np.flatnonzero(on)[0]])
    vals = np.array(ss.graph.attrs["val"], np.float64)
    vals[v] = np.nan
    got, want = ss.run(vals), hs.run(vals)
    _same(got, want, "nan")
    for agg in ("min", "max"):
        lost = np.flatnonzero(np.isnan(got[AGGS.index(agg)]))
        assert 0 < lost.size < ss.graph.n, agg
        assert (st.plan.reducing_shard(lost, 2) == shard).any(), agg


def _layout_case(ell: bool):
    """The reference's sharded-query test case: ER 400, degree 6, KHop(2),
    EMC, tiles of 64; ``ell=False`` drops the ELL layouts."""
    from repro_torch.core import engine_torch as et
    from repro_torch.core.dbindex import build_dbindex
    from repro_torch.core.windows import KHopWindow
    from repro_torch.graphs.generators import erdos_renyi, with_random_attrs

    g = with_random_attrs(erdos_renyi(400, 6.0, seed=1), seed=2)
    idx = build_dbindex(g, KHopWindow(2), method="emc")
    plan = et.plan_from_dbindex(idx, tm=64, ts=64, torch_device="cpu")
    if not ell:
        plan = dataclasses.replace(plan, p1_ell=None, p2_ell=None)
    return g, idx, plan


def _layout_record(sp, key: str, vals) -> dict:
    """Everything the layout test compares, keyed as the reference's
    subprocess keys it."""
    from repro_torch.distributed.window_runtime import query_sharded_multi
    from repro_torch.obs.audit import plan_crc

    out = {f"{key}_crc": np.int64(plan_crc(sp)),
           f"{key}_dims": np.array([sp.rows1, sp.rows2, sp.nb_seg, sp.n_seg, sp.ndev])}
    for name in ("group_shard1", "group_off1", "group_tiles1", "group_shard2",
                 "group_off2", "group_tiles2"):
        out[f"{key}_{name}"] = np.asarray(getattr(sp, name), np.int64)
    for name, a in sp.named_arrays().items():
        out[f"{key}_arr_{name}"] = np.asarray(a)
    for a, r in zip(AGGS, query_sharded_multi(sp, vals, AGGS)):
        out[f"{key}_q_{a}"] = r.numpy()
    return out


# ---------------------------------------------------------------------- #
#  spawned ranks
# ---------------------------------------------------------------------- #
def _w_layout(rank, world, store, out):
    """4 ranks on a (2, 2) ("data", "model") mesh: 2 shards over "data",
    4 over both; every rank records the layout, digest and query."""
    from repro_torch.distributed.window_runtime import build_sharded_plan

    mesh = _init(rank, world, store, (2, 2), ("data", "model"))
    rec = {}
    for ell in (True, False):
        g, _, plan = _layout_case(ell)
        for axis, ndev in (("data", 2), (("data", "model"), 4)):
            sp = build_sharded_plan(plan, mesh, axis)
            assert sp.ndev == ndev
            if ndev == 4:  # a rebuild on the same mesh combines over the same group
                assert build_sharded_plan(plan, mesh, axis).group is sp.group
            rec.update(_layout_record(sp, f"{ndev}_{'ell' if ell else 'noell'}",
                                      g.attrs["val"]))
            # this rank's device holds its own rows only
            lo = sp.shard * sp.rows1
            assert np.array_equal(sp.pass1.tiles.gather_padded.numpy(),
                                  sp.flat["p1_gather"][lo:lo + sp.rows1])
            assert sp.array_nbytes()["p1_gather"] * ndev == sp.flat["p1_gather"].nbytes
    np.savez(f"{out}.{rank}.npz", **rec)
    import torch.distributed as dist

    dist.destroy_process_group()


def _w_stream(rank, world, store, out):
    """World 2: a 12-batch k = 1 stream with ELL layouts, then one without
    (min/max on K1's columns), each bitwise the single-host session's;
    the NaN case; per-rank device bytes; the digest."""
    from repro_torch.core import engine_torch as et

    mesh = _init(rank, world, store)
    rng = np.random.default_rng(23)
    digests = []
    for ell in (True, False):
        if not ell:
            et._ell_from_index = lambda *a: (None, None)
        ss, hs = _stream_pair(mesh)
        st = _state(ss)
        assert st.plan.has_ell == ell and st.plan.shard == rank
        _check_stream(ss, hs, rng, ndev=world)
        _check_nan(ss, hs, shard=1)
        assert st.plan.plan_nbytes() < st.plan.size_bytes()
        digests.append(ss.digest()["plan_crc"])
    with open(f"{out}.{rank}.txt", "w") as f:
        f.write(" ".join(str(d) for d in digests))
    import torch.distributed as dist

    dist.destroy_process_group()


def _k1_launches_per_call(fn) -> tuple:
    """K1's launches in one call of ``fn``, and the scatter / index_add
    calls made outside K1 meanwhile (none on the sharded path)."""
    from repro_torch.kernels.segment_reduce.segment_reduce import segment_sum_tiled

    names = ("scatter_reduce", "scatter_reduce_", "scatter", "scatter_", "scatter_add",
             "scatter_add_", "index_add", "index_add_")
    real = {name: getattr(torch.Tensor, name) for name in names}
    seen = []

    def spy(name):
        def call(self, *a, **kw):
            seen.append(name)
            return real[name](self, *a, **kw)
        return call

    before = segment_sum_tiled.launches
    try:
        for name in names:
            setattr(torch.Tensor, name, spy(name))
        fn()
    finally:
        for name, f in real.items():
            setattr(torch.Tensor, name, f)
    return segment_sum_tiled.launches - before, seen


def _w_stream_cuda(rank, world, store, out):
    """The stream on the card: world 2 over gloo with both ranks on
    ``cuda:0``, or over NCCL one rank a card (``SHARDED_BACKEND``); each
    ``run()`` two K1 launches a rank and nothing scattered, the NaN held
    by rank 1 kept."""
    backend = os.environ["SHARDED_BACKEND"]
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    mesh = _init(rank, world, store, backend=backend)
    ss, hs = _stream_pair(mesh, torch_device=dev, tile=128)
    _check_stream(ss, hs, np.random.default_rng(23), ndev=world)
    launches, scattered = _k1_launches_per_call(ss.run)
    assert (launches, scattered) == (2, []), (launches, scattered)
    vb = np.random.default_rng(1).integers(0, 100, (8, ss.graph.n)).astype(np.float64)
    launches, scattered = _k1_launches_per_call(lambda: ss.run_many(vb))
    assert (launches, scattered) == (2, []), (launches, scattered)
    _check_nan(ss, hs, shard=1)
    with open(f"{out}.{rank}.txt", "w") as f:
        f.write(str(ss.digest()["plan_crc"]))
    import torch.distributed as dist

    dist.destroy_process_group()


_WORKERS = {"layout": _w_layout, "stream": _w_stream, "stream_cuda": _w_stream_cuda}


def _spawn(worker: str, world: int, tmp_path, **env_extra) -> list:
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
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, o[-2000:] + e[-4000:]
    return [tmp_path / f"out.{r}" for r in range(world)]


_REF_LAYOUT = """
import dataclasses, sys
import numpy as np, jax
from jax.sharding import Mesh
from repro.core import engine_jax as ej
from repro.core.dbindex import build_dbindex
from repro.core.windows import KHopWindow
from repro.distributed import window_runtime as wr
from repro.graphs.generators import erdos_renyi, with_random_attrs
from repro.obs.audit import plan_crc

AGGS = {aggs!r}
g = with_random_attrs(erdos_renyi(400, 6.0, seed=1), seed=2)
idx = build_dbindex(g, KHopWindow(2), method="emc")
plan = ej.plan_from_dbindex(idx, tm=64, ts=64)
rec = {{}}
for ell, p in (("ell", plan), ("noell", dataclasses.replace(plan, p1_ell=None, p2_ell=None))):
    for ndev in (1, 2, 4):
        sp = wr.build_sharded_plan(p, Mesh(np.array(jax.devices()[:ndev]), ("data",)), "data")
        key = f"{{ndev}}_{{ell}}"
        rec[key + "_crc"] = np.int64(plan_crc(sp))
        rec[key + "_dims"] = np.array([sp.rows1, sp.rows2, sp.nb_seg, sp.n_seg, sp.ndev])
        for name in ("group_shard1", "group_off1", "group_tiles1", "group_shard2",
                     "group_off2", "group_tiles2"):
            rec[key + "_" + name] = np.asarray(getattr(sp, name), np.int64)
        for name in sp.array_nbytes():
            rec[key + "_arr_" + name] = np.asarray(getattr(sp, name))
        for a, r in zip(AGGS, wr.query_sharded_multi(sp, g.attrs["val"], AGGS)):
            rec[key + "_q_" + a] = np.asarray(r)
np.savez(sys.argv[1], **rec)
"""


# ---------------------------------------------------------------------- #
#  world size 1, in this process
# ---------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def mesh1(tmp_path_factory):
    import torch.distributed as dist

    mesh = _init(0, 1, str(tmp_path_factory.mktemp("gloo") / "store"))
    yield mesh
    dist.destroy_process_group()


def test_session_mesh_kwarg_builds_sharded_session(mesh1):
    from repro_torch.core.api import QuerySpec, Session
    from repro_torch.distributed import ShardedDBPlan, ShardedSession
    from repro_torch.graphs.generators import erdos_renyi, with_random_attrs

    g = with_random_attrs(erdos_renyi(200, 4.0, directed=False, seed=3), seed=4)
    sess = Session(g, [QuerySpec(("khop", 1), a) for a in AGGS], mesh=mesh1,
                   torch_device="cpu")
    assert isinstance(sess, ShardedSession) and sess._sharded
    assert [grp.engine for grp in sess.compiled.groups] == ["torch-sharded"]
    assert isinstance(_state(sess).plan, ShardedDBPlan)
    host = Session(g, [QuerySpec(("khop", 1), a) for a in AGGS], torch_device="cpu")
    assert type(host) is Session and host.compiled.groups[0].engine == "torch"
    _same(sess.run(), host.run())


@pytest.mark.parametrize("ell", [True, False], ids=["ell", "no_ell"])
def test_world1_stream_bitwise_single_host(mesh1, monkeypatch, ell):
    from repro_torch.core import engine_torch as et

    if not ell:
        monkeypatch.setattr(et, "_ell_from_index", lambda *a: (None, None))
    ss, hs = _stream_pair(mesh1)
    assert _state(ss).plan.has_ell == ell
    _check_stream(ss, hs, np.random.default_rng(13))
    _check_nan(ss, hs, shard=0)


@pytest.mark.parametrize("ell", [True, False], ids=["ell", "no_ell"])
def test_sharded_run_is_one_k1_call_per_pass_and_no_scatter(mesh1, monkeypatch, ell):
    """Each pass of each shard is one K1 call (the single-host session's
    monoid split), ``run_many``'s batch on its columns; nothing outside K1
    scatters or index-adds."""
    from repro_torch.core import engine_torch as et
    from repro_torch.kernels.segment_reduce import ops as k1_ops

    if not ell:
        monkeypatch.setattr(et, "_ell_from_index", lambda *a: (None, None))
    ss, hs = _stream_pair(mesh1)
    calls, inside = [], [False]
    k1 = k1_ops.segment_reduce_tiled

    def counted(values, *a, monoids, **kw):
        calls.append((values.shape[1], tuple(monoids)))
        inside[0] = True
        try:
            return k1(values, *a, monoids=monoids, **kw)
        finally:
            inside[0] = False

    def spy(name):
        real = getattr(torch.Tensor, name)

        def call(self, *a, **kw):
            if not inside[0]:  # K1's plain version on the CPU scatters inside
                scattered.append(name)
            return real(self, *a, **kw)
        return call

    scattered = []
    monkeypatch.setattr(k1_ops, "segment_reduce_tiled", counted)
    for name in ("scatter_reduce", "scatter_reduce_", "scatter", "scatter_", "scatter_add",
                 "scatter_add_", "index_add", "index_add_"):
        monkeypatch.setattr(torch.Tensor, name, spy(name))
    got = ss.run()
    vb = np.random.default_rng(5).integers(0, 100, (8, ss.graph.n)).astype(np.float64)
    many = ss.run_many(vb)
    monkeypatch.undo()
    assert scattered == []
    if ell:
        assert calls == [(1, (1, 0, 0)), (2, (2, 0, 0)), (8, (8, 0, 0)), (16, (16, 0, 0))]
    else:
        assert calls == [(3, (1, 1, 1)), (4, (2, 1, 1)), (24, (8, 8, 8)), (32, (16, 8, 8))]
    _same(many, hs.run_many(vb))
    _same(got, hs.run())


def test_world1_k2_stream_rebuilds_stay_bitwise(mesh1):
    """KHop(2) under the deferred policy: the phase-1 merges' link growth
    (R2) outgrows tile groups, so the sharded plan rebuilds on some
    batches; every answer stays bitwise the single-host session's and
    each patch-only batch ships less than the full plan."""
    ss, hs = _stream_pair(mesh1, k=2, headroom=0.5, seed=5)
    rng = np.random.default_rng(6)
    kinds = []
    for step in range(6):
        b = _mixed(hs.graph, rng, 6, 3)
        (rep,) = ss.update(b).values()
        hs.update(b)
        kinds.append(rep["plan_rebuilt"])
        if not rep["plan_rebuilt"]:
            assert 0 < rep["patch_bytes"] < rep["full_plan_bytes"]
        _same(ss.run(), hs.run(), step)
    assert any(kinds)


def test_world1_spmd_affected_owners_equals_union(mesh1):
    from repro_torch.core.updates import (
        apply_batch,
        sharded_affected_owners,
        spmd_affected_owners,
    )
    from repro_torch.core.windows import KHopWindow
    from repro_torch.graphs.generators import erdos_renyi

    g = erdos_renyi(300, 4.0, directed=False, seed=8)
    b = _mixed(g, np.random.default_rng(9), 6, 3)
    g2 = apply_batch(g, b)
    import torch.distributed as dist

    owners, sizes = spmd_affected_owners(g2, KHopWindow(2), b, 1, 0,
                                         group=dist.group.WORLD, torch_device="cpu")
    want, per = sharded_affected_owners(g2, KHopWindow(2), b, 1, torch_device="cpu")
    assert np.array_equal(owners, want) and sizes == [p.size for p in per]


def test_pinned_view_over_sharded_session_keeps_its_answers(mesh1):
    ss, hs = _stream_pair(mesh1)
    view = ss.snapshot()
    before = view.run()
    rng = np.random.default_rng(31)
    for _ in range(3):
        b = _mixed(hs.graph, rng, 4, 2)
        (rep,) = ss.update(b).values()
        hs.update(b)
        assert rep["plan_clone_bytes"] in (0, _state(ss).plan.plan_nbytes())
    assert ss.plan_clones == 1  # only the first update found the view's plan live
    _same(view.run(), before, "pinned")
    _same(ss.run(), hs.run(), "head")
    del view


def test_sharded_plan_bytes_are_the_device_shard(mesh1):
    ss, _ = _stream_pair(mesh1)
    plan = _state(ss).plan
    dev = plan.device_arrays()
    assert plan.array_nbytes() == {k: t.numel() * t.element_size() for k, t in dev.items()}
    assert plan.plan_nbytes() == sum(plan.array_nbytes().values())
    assert plan.size_bytes() == sum(a.nbytes for a in plan.named_arrays().values())
    assert plan.stats["full_bytes"] == plan.size_bytes()
    assert plan.pass1.tiles.gather_padded.numel() == plan.rows1


def test_one_shot_registry_route_matches_single_host(mesh1):
    from repro_torch.core.api import DEFAULT_REGISTRY
    from repro_torch.core.windows import KHopWindow
    from repro_torch.graphs.generators import erdos_renyi, with_random_attrs

    g = with_random_attrs(erdos_renyi(150, 3.0, directed=False, seed=14), seed=15)
    w = KHopWindow(1)
    got = DEFAULT_REGISTRY.run("torch-sharded", g, w, g.attrs["val"], AGGS, mesh=mesh1,
                               torch_device="cpu")
    want = DEFAULT_REGISTRY.run("torch", g, w, g.attrs["val"], AGGS, torch_device="cpu")
    _same([got[a] for a in AGGS], [want[a] for a in AGGS])
    with pytest.raises(Exception, match="mesh"):
        DEFAULT_REGISTRY.run("torch-sharded", g, w, g.attrs["val"], AGGS,
                             torch_device="cpu")


@pytest.mark.parametrize("engine", ["torch", "torch-sharded"])
def test_one_shot_route_defaults_to_the_card(mesh1, monkeypatch, engine):
    """Without ``torch_device`` the one-shot sharded route, like the
    single-host one, asks for the card and raises where there is none
    (it never lands on the CPU unasked)."""
    from repro_torch.core.query import GraphWindowQuery
    from repro_torch.core.windows import KHopWindow
    from repro_torch.graphs.generators import erdos_renyi, with_random_attrs

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = with_random_attrs(erdos_renyi(120, 3.0, directed=False, seed=16), seed=17)
    q = GraphWindowQuery(KHopWindow(1), "sum")
    with pytest.raises(RuntimeError, match="torch_device='cuda'"):
        q.run(g, engine=engine, mesh=mesh1)


def test_topological_window_on_a_mesh_bitwise_single_host(mesh1):
    from repro_torch.core.api import QuerySpec, Session
    from repro_torch.graphs.generators import random_dag, with_random_attrs

    g = with_random_attrs(random_dag(300, 3.0, seed=5), seed=6)
    specs = [QuerySpec("topological", a) for a in ("sum", "min", "max")]
    ss = Session(g, specs, mesh=mesh1, tm=64, ts=64, torch_device="cpu")
    assert ss.compiled.groups[0].engine == "torch-sharded"
    assert _state(ss).method == "mc"
    hs = Session(g, specs, device=False, torch_device="cpu")  # the host index
    _same(ss.run(), hs.run())


def test_analyze_on_a_sharded_session_matches_run(mesh1):
    """ANALYZE times a sharded term as one phase (its runner: the K1
    passes and the combine) and returns ``run()``'s results."""
    ss, _ = _stream_pair(mesh1)
    want = ss.run()
    rep = ss.analyze()
    assert {p["phase"] for p in rep.phases} == {"host_prep", "materialize"}
    for (gi, ai), w in zip(ss.compiled.spec_slots, want):
        got = rep.results[gi][ss.compiled.groups[gi].aggs[ai]]
        assert got.dtype == w.dtype and got.tobytes() == w.tobytes()


def test_explain_sharded_anatomy_keys_match_reference(mesh1):
    pytest.importorskip("jax")
    import jax
    from jax.sharding import Mesh

    import repro.core.api as r_api
    from repro.graphs import generators as r_gen

    from repro_torch.core.api import QuerySpec, Session
    from repro_torch.graphs import generators as p_gen

    def graph(gen):
        return gen.with_random_attrs(gen.erdos_renyi(300, 4.0, directed=False, seed=3),
                                     seed=4)

    rs = r_api.Session(graph(r_gen), [r_api.QuerySpec(("khop", 1), a) for a in AGGS],
                       mesh=Mesh(np.array(jax.devices()[:1]), ("data",)), tm=64, ts=64)
    ps = Session(graph(p_gen), [QuerySpec(("khop", 1), a) for a in AGGS], mesh=mesh1,
                 tm=64, ts=64, torch_device="cpu")
    rr, pr = rs.explain(), ps.explain()
    assert rr.sharded and pr.sharded
    (rt,), (pt,) = rr.groups[0].terms, pr.groups[0].terms
    assert rt.plan_kind == pt.plan_kind == "ShardedDBPlan"
    assert rt.plan.keys() == pt.plan.keys()
    for key in ("shard_balance", "patch_ledger"):
        assert rt.plan[key].keys() == pt.plan[key].keys(), key
    assert rt.plan["shard_balance"] == pt.plan["shard_balance"]
    for key in ("ndev", "num_blocks", "block_capacity", "rows1_per_shard",
                "rows2_per_shard", "has_ell"):
        assert rt.plan[key] == pt.plan[key], key
    assert pr.groups[0].capability["sharded"] and pr.groups[0].capability["priority"] == 70


# ---------------------------------------------------------------------- #
#  host layout (no collective)
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("ndev", [1, 2, 3, 4])
def test_shard_k1_plans_keep_k1s_contract(ndev):
    """Each shard's K1 plan: non-decreasing output tiles, each with an
    input tile, valid rows first and sorted within a group; mapped back
    through ``groups`` its rows are the canonical span's."""
    from repro_torch.distributed import window_runtime as wr

    for ell in (True, False):
        _, _, plan = _layout_case(ell)
        tiles, starts = wr._group_layout(plan.pass2)
        shard_of, off, cap = wr._assign_groups(tiles * plan.pass2.tm, ndev)
        seg, gather = wr._pack_shards(plan.pass2.seg_tiles.numpy().reshape(-1),
                                      plan.pass2.gather_padded.numpy(), starts,
                                      tiles * plan.pass2.tm, shard_of, off, cap, ndev)
        for s in range(ndev):
            sp = wr._shard_pass(seg, gather, shard_of, off, tiles, cap, s, 64, 64, "cpu")
            m2out = sp.tiles.m2out.numpy()
            assert (np.diff(m2out) >= 0).all()
            assert np.array_equal(np.unique(m2out), np.arange(sp.tiles.num_out_tiles))
            local = sp.tiles.seg_tiles.numpy().reshape(-1)
            canon = seg[s * cap:(s + 1) * cap]
            groups = sp.groups.numpy()
            back = np.where(local >= 0, groups[np.maximum(local, 0) // 64] * 64 + local % 64,
                            -1)
            assert np.array_equal(back, canon)
            assert np.array_equal(sp.tiles.gather_padded.numpy(), gather[s * cap:(s + 1) * cap])


# ---------------------------------------------------------------------- #
#  against the reference
# ---------------------------------------------------------------------- #
def _ref_graphs(window_kind):
    from repro.graphs import generators as r_gen

    from repro_torch.graphs import generators as p_gen

    if window_kind == "topological":
        return (r_gen.random_dag(300, 3.0, seed=5), p_gen.random_dag(300, 3.0, seed=5))
    return (r_gen.erdos_renyi(300, 4.0, directed=False, seed=8),
            p_gen.erdos_renyi(300, 4.0, directed=False, seed=8))


def test_torch_sharded_capability_row_matches_jax_sharded():
    pytest.importorskip("jax")
    import repro.core.api as r_api

    import repro_torch.core.api as p_api

    def row(reg, name):
        c = reg.capability(name)
        return (c.windows, c.device, c.sharded, c.incremental, c.priority)

    assert row(p_api.DEFAULT_REGISTRY, "torch-sharded") == row(r_api.DEFAULT_REGISTRY,
                                                               "jax-sharded")
    w = p_api.as_window(("khop", 2))
    assert p_api.DEFAULT_REGISTRY.select(w, AGGS, sharded=True) == "torch-sharded"
    assert p_api.DEFAULT_REGISTRY.select(w, AGGS) == "torch"


@pytest.mark.parametrize("case", ["khop1", "khop2", "composite", "topological"])
def test_sharded_affected_owners_matches_reference(case):
    pytest.importorskip("jax")
    from repro.core import updates as r_up
    from repro.core import windows as r_win

    from repro_torch.core import updates as p_up
    from repro_torch.core import windows as p_win

    windows = {
        "khop1": (r_win.KHopWindow(1), p_win.KHopWindow(1)),
        "khop2": (r_win.KHopWindow(2), p_win.KHopWindow(2)),
        "composite": (r_win.Union(r_win.KHop(1, "out"), r_win.KHop(2, "in")),
                      p_win.Union(p_win.KHop(1, "out"), p_win.KHop(2, "in"))),
        "topological": (r_win.TopologicalWindow(), p_win.TopologicalWindow()),
    }
    rw, pw = windows[case]
    rg, pg = _ref_graphs(case)
    rng = np.random.default_rng(17)
    if case == "topological":  # DAG inserts: from a lower id to a higher one
        a, b = np.sort(rng.integers(0, pg.n, (2, 12)), axis=0)
        keep = a < b
        src, dst, op = a[keep], b[keep], np.ones(keep.sum(), np.int8)
    else:
        pb = _mixed(pg, rng, 8, 4)
        src, dst, op = pb.src, pb.dst, pb.op
    rb, pb = r_up.UpdateBatch(src, dst, op), p_up.UpdateBatch(src, dst, op)
    rg2, pg2 = r_up.apply_batch(rg, rb), p_up.apply_batch(pg, pb)
    for shards in (1, 2, 3, 4):
        ro, rper = r_up.sharded_affected_owners(rg2, rw, rb, shards, use_device=False)
        for dev_route in (False, True):
            po, pper = p_up.sharded_affected_owners(pg2, pw, pb, shards, use_device=dev_route,
                                                    torch_device="cpu")
            assert np.array_equal(po, ro), (shards, dev_route)
            assert len(pper) == len(rper) == shards
            for x, y in zip(pper, rper):
                assert np.array_equal(x, y), (shards, dev_route)


def test_layout_crc_and_query_match_reference(tmp_path, mesh1):
    """The host layout (``group_*``, ``rows1/2``, the flat ``p1/p2`` seg and
    gather, the ELL shards), ``plan_crc`` and ``query_sharded_multi``
    (NaN-free: the reference's MIN/MAX lose a NaN held by a later shard,
    R8) equal the reference's at 1, 2 and 4 shards, with ELL layouts and
    without.  The reference runs on 4 forced host devices; the port's 2
    and 4 shards are 4 spawned ranks on a (2, 2) mesh, its 1 shard this
    process."""
    pytest.importorskip("jax")
    from repro_torch.distributed.window_runtime import build_sharded_plan

    ref_out = tmp_path / "ref.npz"
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_REF_LAYOUT.format(aggs=AGGS)), str(ref_out)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
             "XLA_FLAGS": "--xla_force_host_platform_device_count=4"})
    try:
        outs = _spawn("layout", 4, tmp_path)
        o, e = ref.communicate(timeout=SPAWN_TIMEOUT_S)
    finally:
        ref.kill()
    assert ref.returncode == 0, e[-4000:]
    want = dict(np.load(ref_out))
    got = {}
    for ell in (True, False):
        g, _, plan = _layout_case(ell)
        got.update(_layout_record(build_sharded_plan(plan, mesh1, "data"),
                                  f"1_{'ell' if ell else 'noell'}", g.attrs["val"]))
    ranks = [dict(np.load(f"{p}.npz")) for p in outs]
    for r in ranks[1:]:
        assert r.keys() == ranks[0].keys()
        for k in r:
            assert np.array_equal(r[k], ranks[0][k]), k
    got.update(ranks[0])
    assert got.keys() == want.keys()
    for k in sorted(want):
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_world2_stream_bitwise_single_host_with_nan(tmp_path):
    """Two spawned gloo ranks: the 12-batch streams (ELL, then K1's min/max
    columns), each answer bitwise the single-host session's, every slice's
    owner count, a NaN held only by rank 1 kept in min/max; both ranks
    hold the same digest."""
    outs = _spawn("stream", 2, tmp_path)
    digests = [pathlib.Path(f"{p}.txt").read_text() for p in outs]
    assert digests[0] == digests[1]


if __name__ == "__main__":
    _WORKERS[sys.argv[1]](int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])

"""The sharded plan's patch stream as a replication stream (the port's
``encode_wire_message`` / ``decode_wire_message`` / ``apply_wire_message``),
on the CPU over a gloo world of one.

A follower holding the leader's initial plan replays every message and
answers bit for bit as the leader, through ``"patch"`` and ``"resync"``
messages; each replay checks the leader's ``plan_crc`` stamp.  The codec
is ``np.savez``-framed, whose zip members carry timestamps, so the two
packages are held to decode equality, not byte equality.  The reference's
own sharded streaming fails on this tree (R1), so its messages are the
port's, encoded by the reference's codec.
"""

import datetime

import numpy as np
import pytest

torch = pytest.importorskip("torch")

AGGS = ("sum", "count", "avg", "min", "max")


@pytest.fixture(scope="module")
def mesh1(tmp_path_factory):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    store = dist.FileStore(str(tmp_path_factory.mktemp("gloo") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=90))
    yield init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
    dist.destroy_process_group()


def _mixed(g, rng, n_ins, n_del):
    from repro_torch.core.updates import UpdateBatch

    s = rng.integers(0, g.n, n_ins * 4).astype(np.int32)
    d = rng.integers(0, g.n, n_ins * 4).astype(np.int32)
    ok = (s != d) & ~g.contains_edges(s, d)
    _, first = np.unique(g.edge_keys(s, d), return_index=True)
    pick = np.intersect1d(np.flatnonzero(ok), first)[:n_ins]
    ins = UpdateBatch.inserts(s[pick], d[pick])
    ei = rng.choice(g.n_edges, min(n_del, g.n_edges), replace=False)
    return UpdateBatch.concat([ins, UpdateBatch.deletes(g.src[ei], g.dst[ei])])


def _leader_and_follower(mesh):
    """The reference's replication case: ER 400, degree 3, KHop(1), tiles
    of 64, headroom 1.0; the follower's plan built from the same graph."""
    from repro_torch.core import engine_torch as et
    from repro_torch.core.dbindex import build_dbindex
    from repro_torch.core.windows import KHopWindow
    from repro_torch.distributed import window_runtime as wr
    from repro_torch.graphs.generators import erdos_renyi, with_random_attrs

    g = with_random_attrs(erdos_renyi(400, 3.0, directed=False, seed=21), seed=22)
    w = KHopWindow(1)
    leader = wr.ShardedStreamState(g, w, mesh, tm=64, ts=64, plan_headroom=1.0,
                                   capture_wire=True, torch_device="cpu")
    fidx = build_dbindex(g, w, method=leader.method)
    base = et.plan_from_dbindex(fidx, 64, 64, headroom=1.0, torch_device="cpu")
    return leader, wr.build_sharded_plan(base, mesh, "data", headroom=1.0)


def _stream(leader, steps, resync_at=None, seed=23):
    """Apply ``steps`` batches to the leader (forcing a rebuild after step
    ``resync_at``); yields after each step."""
    rng = np.random.default_rng(seed)
    for step in range(steps):
        leader.apply(_mixed(leader.graph, rng, 4, 2))
        if step == resync_at:
            leader._build()  # one "resync" message on the wire
        yield step


def test_wire_follower_bitwise_leader_through_patch_and_resync(mesh1):
    from repro_torch.distributed import window_runtime as wr
    from repro_torch.obs.audit import plan_crc

    leader, fplan = _leader_and_follower(mesh1)
    assert plan_crc(fplan) == plan_crc(leader.plan)
    kinds, consumed = [], 0
    for step in _stream(leader, 12, resync_at=7):
        for msg in leader.wire_log[consumed:]:
            msg2 = wr.decode_wire_message(wr.encode_wire_message(msg))
            kinds.append(msg2["kind"])
            fplan = wr.apply_wire_message(fplan, msg2)
        consumed = len(leader.wire_log)
        vals = leader.graph.attrs["val"]
        got = wr.query_sharded_multi(fplan, vals, AGGS)
        for a, x, y in zip(AGGS, got, leader.query_multi(AGGS)):
            assert np.array_equal(x.numpy(), y), (step, a)
        assert plan_crc(fplan) == plan_crc(leader.plan), step
        for name, t in fplan.device_arrays().items():
            assert torch.equal(t, leader.plan.device_arrays()[name]), (step, name)
    assert "patch" in kinds and "resync" in kinds, kinds
    assert leader.plan.stats["version"] == fplan.stats["version"]


def test_flipped_byte_raises_wire_divergence(mesh1):
    """A message corrupted after the codec (one byte of one patch array)
    replays into a plan whose digest is not the leader's stamp."""
    from repro_torch.distributed import window_runtime as wr

    leader, fplan = _leader_and_follower(mesh1)
    next(_stream(leader, 1))
    (msg,) = leader.wire_log
    assert msg["kind"] == "patch"
    bad = wr.decode_wire_message(wr.encode_wire_message(msg))
    gather = bad["patches"][0][3]
    gather.view(np.uint8)[np.flatnonzero(gather)[0] * 4] ^= 1
    with pytest.raises(wr.WireDivergenceError, match="patch replay digest mismatch"):
        wr.apply_wire_message(fplan, bad)
    # without the check the replay goes through
    _, fresh = _leader_and_follower(mesh1)
    wr.apply_wire_message(fresh, bad, verify=False)


def test_stream_gap_raises_wire_divergence(mesh1):
    """A follower that missed a message diverges on the next one."""
    from repro_torch.distributed import window_runtime as wr

    leader, fplan = _leader_and_follower(mesh1)
    for _ in _stream(leader, 2):
        pass
    assert [m["kind"] for m in leader.wire_log] == ["patch", "patch"]
    with pytest.raises(wr.WireDivergenceError):
        wr.apply_wire_message(fplan, leader.wire_log[1])


def _same_message(a: dict, b: dict):
    assert a["kind"] == b["kind"] and a.get("plan_crc") == b.get("plan_crc")
    if a["kind"] == "resync":
        ia, ib = a["index"], b["index"]
        assert (ia.n, ia.num_blocks, ia.stats) == (ib.n, ib.num_blocks, ib.stats)
        for f in ("block_members", "block_offsets", "link_block", "link_owner_offsets"):
            x, y = getattr(ia, f), getattr(ib, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), f
        return
    assert a["num_blocks"] == b["num_blocks"]
    assert len(a["patches"]) == len(b["patches"])
    for pa, pb in zip(a["patches"], b["patches"]):
        assert pa[0] == pb[0]
        for x, y in zip(pa[1:], pb[1:]):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    for key in ("block_ids", "block_sizes", "e1_ids", "e1_rows", "e2_ids", "e2_rows"):
        x, y = a[key], b[key]
        if x is None or y is None:
            assert x is None and y is None, key
        else:
            assert x.dtype == y.dtype and np.array_equal(x, y), key


def test_wire_decode_equality_across_packages(mesh1):
    """The reference decodes the port's bytes to the port's message, and
    the port decodes the reference's bytes of the same message."""
    pytest.importorskip("jax")
    from repro.core.dbindex import DBIndex as RefDBIndex
    from repro.distributed import window_runtime as rwr

    from repro_torch.distributed import window_runtime as wr

    leader, _ = _leader_and_follower(mesh1)
    for _ in _stream(leader, 3, resync_at=1):
        pass
    kinds = [m["kind"] for m in leader.wire_log]
    assert kinds == ["patch", "patch", "resync", "patch"], kinds
    for msg in leader.wire_log:
        port_bytes = wr.encode_wire_message(msg)
        via_ref = rwr.decode_wire_message(port_bytes)
        want = wr.decode_wire_message(port_bytes)
        if msg["kind"] == "resync":
            assert isinstance(via_ref["index"], RefDBIndex)
        _same_message(via_ref, want)
        ref_msg = dict(msg)
        if msg["kind"] == "resync":
            idx = msg["index"]
            ref_msg["index"] = RefDBIndex(n=idx.n, num_blocks=idx.num_blocks,
                                          block_members=idx.block_members,
                                          block_offsets=idx.block_offsets,
                                          link_block=idx.link_block,
                                          link_owner_offsets=idx.link_owner_offsets,
                                          stats=dict(idx.stats))
        ref_bytes = rwr.encode_wire_message(ref_msg)
        _same_message(wr.decode_wire_message(ref_bytes), want)
        if msg["kind"] == "resync":
            # the port's resync also names the capacity the leader's
            # rebuild asked for; the reference's codec drops it
            assert want["capacity"] == msg["capacity"]
            assert "capacity" not in via_ref
            assert "capacity" not in wr.decode_wire_message(ref_bytes)
        else:  # the JSON header of a patch is the same bytes
            assert ref_bytes[:4 + int.from_bytes(ref_bytes[:4], "little")] == \
                port_bytes[:4 + int.from_bytes(port_bytes[:4], "little")]


def test_patch_messages_ship_less_than_the_plan(mesh1):
    from repro_torch.distributed import window_runtime as wr

    leader, _ = _leader_and_follower(mesh1)
    for _ in _stream(leader, 4):
        pass
    full = leader.plan.size_bytes()
    for msg in leader.wire_log:
        assert msg["kind"] == "patch"
        assert len(wr.encode_wire_message(msg)) < full
    assert 0 < leader.plan.stats["last_patch_bytes"] < full


def test_resync_lands_on_the_leaders_plan_unlike_the_reference(mesh1):
    """R9: a reorganize's ``"resync"`` names no capacity in the reference,
    whose follower rebuilds at its own capacity grown by the headroom
    again, so its plan (and every later digest check) differs from the
    leader's; the port's resync names the capacity and carries the stamp."""
    pytest.importorskip("jax")
    import jax
    from jax.sharding import Mesh

    from repro.core import engine_jax as ej
    from repro.core.dbindex import build_dbindex as r_build
    from repro.core.windows import KHopWindow as RKHop
    from repro.distributed import window_runtime as rwr
    from repro.graphs.generators import erdos_renyi as r_er
    from repro.graphs.generators import with_random_attrs as r_attrs
    from repro.obs.audit import plan_crc as r_crc

    from repro_torch.distributed import window_runtime as wr
    from repro_torch.obs.audit import plan_crc

    rmesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    g = r_attrs(r_er(400, 3.0, directed=False, seed=21), seed=22)
    rleader = rwr.ShardedStreamState(g, RKHop(1), rmesh, tm=64, ts=64, plan_headroom=1.0,
                                     capture_wire=True)
    rbase = ej.plan_from_dbindex(r_build(g, RKHop(1), method="emc"), 64, 64, headroom=1.0)
    rfollower = rwr.build_sharded_plan(rbase, rmesh, "data", headroom=1.0)
    start = r_crc(rfollower)
    rleader._build()
    rfollower = rwr.apply_wire_message(rfollower, rleader.wire_log[-1])
    assert rfollower.block_capacity > rleader.plan.block_capacity
    assert r_crc(rfollower) != r_crc(rleader.plan)

    leader, follower = _leader_and_follower(mesh1)
    assert plan_crc(follower) == start  # the reference's starting plan
    leader._build()
    msg = wr.decode_wire_message(wr.encode_wire_message(leader.wire_log[-1]))
    assert msg["capacity"] is None and msg["plan_crc"] == plan_crc(leader.plan)
    follower = wr.apply_wire_message(follower, msg)
    assert follower.block_capacity == leader.plan.block_capacity
    assert plan_crc(follower) == plan_crc(leader.plan)

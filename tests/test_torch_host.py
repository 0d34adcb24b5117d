"""Port vs reference: host structures are array-equal.

For the same graph and seed, the port's DBIndex, its device tile plans
(every ``TilePlan`` field of pass 1 and pass 2, with and without headroom)
and its min/max ELL layouts equal the reference's — the port's query path
then starts from exactly the state the reference's does.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import engine_jax as ej  # noqa: E402
from repro.core import dbindex as r_dbindex  # noqa: E402
from repro.core import iindex as r_iindex  # noqa: E402
from repro.core import nonindex as r_nonindex  # noqa: E402
from repro.core import updates as r_updates  # noqa: E402
from repro.core import windows as r_windows  # noqa: E402
from repro.graphs import generators as r_gen  # noqa: E402

from repro_torch.core import engine_torch as et  # noqa: E402
from repro_torch.core import dbindex as p_dbindex  # noqa: E402
from repro_torch.core import iindex as p_iindex  # noqa: E402
from repro_torch.core import nonindex as p_nonindex  # noqa: E402
from repro_torch.core import updates as p_updates  # noqa: E402
from repro_torch.core import windows as p_windows  # noqa: E402
from repro_torch.graphs import generators as p_gen  # noqa: E402

TILE_FIELDS = ("gather_padded", "seg_tiles", "m2out", "first_visit",
               "num_segments", "num_out_tiles", "tm", "ts")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return None if x is None else np.asarray(x)


def plan_fields(plan) -> dict:
    """Every array and static int of a DBIndex plan, either package's."""
    out = {"n": plan.n, "num_blocks": int(plan.num_blocks),
           "block_capacity": plan.block_capacity}
    for name in ("block_sizes", "link_counts", "p1_ell", "p2_ell"):
        out[name] = _np(getattr(plan, name))
    for p in ("pass1", "pass2"):
        tp = getattr(plan, p)
        for f in TILE_FIELDS:
            v = getattr(tp, f)
            out[f"{p}.{f}"] = v if isinstance(v, int) else _np(v)
    return out


def assert_plans_equal(ref_plan, port_plan):
    a, b = plan_fields(ref_plan), plan_fields(port_plan)
    assert a.keys() == b.keys()
    for k in a:
        if a[k] is None or b[k] is None:
            assert a[k] is None and b[k] is None, k
        elif isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k
    assert ref_plan.array_nbytes() == port_plan.array_nbytes()


def assert_index_equal(ri, pi):
    assert (ri.n, ri.num_blocks) == (pi.n, pi.num_blocks)
    for f in ("block_members", "block_offsets", "link_block",
              "link_owner_offsets"):
        a, b = getattr(ri, f), getattr(pi, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    timing = {k for k in ri.stats if k.startswith("t_")}
    assert ({k: v for k, v in ri.stats.items() if k not in timing}
            == {k: v for k, v in pi.stats.items() if k not in timing})


@pytest.mark.parametrize("directed", [False, True])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("method", ["emc", "mc"])
def test_dbindex_and_plans_equal(directed, k, method):
    rg = r_gen.erdos_renyi(300, 6.0, directed=directed, seed=21)
    pg = p_gen.erdos_renyi(300, 6.0, directed=directed, seed=21)
    assert np.array_equal(rg.src, pg.src) and np.array_equal(rg.dst, pg.dst)
    ri = r_dbindex.build_dbindex(rg, r_windows.KHopWindow(k), method=method)
    pi = p_dbindex.build_dbindex(pg, p_windows.KHopWindow(k), method=method)
    assert_index_equal(ri, pi)
    for headroom in (0.0, 0.5):
        rp = ej.plan_from_dbindex(ri, headroom=headroom)
        pp = et.plan_from_dbindex(pi, headroom=headroom, torch_device="cpu")
        assert_plans_equal(rp, pp)


def test_skewed_graph_plan_without_ell_equal():
    """Barabási–Albert hubs blow the padded ELL layout up: both packages
    drop it, so MIN/MAX take the masked segment-reduce path."""
    rg = r_gen.barabasi_albert(400, 2, seed=7)
    pg = p_gen.barabasi_albert(400, 2, seed=7)
    ri = r_dbindex.build_dbindex(rg, r_windows.KHopWindow(2), method="emc")
    pi = p_dbindex.build_dbindex(pg, p_windows.KHopWindow(2), method="emc")
    assert_index_equal(ri, pi)
    rp = ej.plan_from_dbindex(ri, headroom=0.5)
    pp = et.plan_from_dbindex(pi, headroom=0.5, torch_device="cpu")
    assert rp.p1_ell is None and pp.p1_ell is None
    assert_plans_equal(rp, pp)


def test_iindex_and_host_engines_equal():
    rg = r_gen.with_random_attrs(r_gen.random_dag(200, 3.0, seed=5), seed=6)
    pg = p_gen.with_random_attrs(p_gen.random_dag(200, 3.0, seed=5), seed=6)
    ri, pi = r_iindex.build_iindex(rg), p_iindex.build_iindex(pg)
    for f in ("pid", "wd_members", "wd_offsets", "level", "topo_order"):
        assert np.array_equal(getattr(ri, f), getattr(pi, f)), f
    vals = rg.attrs["val"]
    for agg in ("sum", "min", "avg"):
        assert np.array_equal(ri.query(vals, agg), pi.query(vals, agg))
        assert np.array_equal(
            r_nonindex.query_batched_bitset(rg, r_windows.TopologicalWindow(), vals, agg),
            p_nonindex.query_batched_bitset(pg, p_windows.TopologicalWindow(), vals, agg))


def test_update_batch_codec_bytes_equal():
    rng = np.random.default_rng(3)
    s, d = rng.integers(0, 50, 6), rng.integers(0, 50, 6)
    rb = r_updates.UpdateBatch.inserts(s, d, ts=np.arange(6.0))
    pb = p_updates.UpdateBatch.inserts(s, d, ts=np.arange(6.0))
    assert rb.to_bytes() == pb.to_bytes()
    back = p_updates.UpdateBatch.from_bytes(rb.to_bytes())
    assert np.array_equal(back.src, s) and np.array_equal(back.ts, np.arange(6.0))
    ra = r_updates.UpdateBatch.attr_set("val", [1, 2], np.array([3.0, 4.0]))
    pa = p_updates.UpdateBatch.attr_set("val", [1, 2], np.array([3.0, 4.0]))
    assert ra.to_bytes() == pa.to_bytes()


def test_device_graph_matches_reference():
    from repro.core.graph import DeviceGraph as RDeviceGraph
    from repro_torch.core.graph import DeviceGraph as PDeviceGraph

    g = r_gen.with_random_attrs(r_gen.erdos_renyi(120, 4.0, seed=2), seed=3)
    pg = p_gen.with_random_attrs(p_gen.erdos_renyi(120, 4.0, seed=2), seed=3)
    rd = RDeviceGraph.from_graph(g, pad_to=1000)
    pd = PDeviceGraph.from_graph(pg, pad_to=1000, torch_device="cpu")
    assert (rd.n, rd.n_edges) == (pd.n, pd.n_edges) and pd.device.type == "cpu"
    for f in ("edge_src", "edge_dst"):
        assert np.array_equal(np.asarray(getattr(rd, f)), getattr(pd, f).numpy()), f
    assert np.array_equal(np.asarray(rd.attrs["val"]), pd.attrs["val"].numpy())

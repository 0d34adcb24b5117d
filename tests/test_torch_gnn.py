"""The GNN family of the port (``repro_torch.models.gnn``) against the
reference on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
port's params come from the reference's ``*_init`` tree through
``convert.gnn_params_from_arrays``.  On the CPU the port's aggregation is
K1's plain version (``index_add_`` / ``scatter_reduce`` over the graph's
tile plan) and the reference's is ``jax.ops.segment_sum`` / ``segment_max``:
the two add in different orders, so float outputs agree within
``rtol = 1e-4, atol = 1e-5`` (a few float32 ulps of each sum, carried
through two layers or three processor steps of float32 matmuls).  The k-hop
window sum on integer features is exact, so it is compared bit for bit.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import gat_cora as r_gat_cfg  # noqa: E402
from repro.configs import gcn_cora as r_gcn_cfg  # noqa: E402
from repro.configs import graphsage_reddit as r_sage_cfg  # noqa: E402
from repro.configs import meshgraphnet as r_mgn_cfg  # noqa: E402
from repro.models import gnn as rg  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import gat_cora, gcn_cora, graphsage_reddit, meshgraphnet  # noqa: E402
from repro_torch.models import gnn  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
N, E_VALID, E_PAD = 40, 150, 10
CFGS = {"gcn": (gcn_cora, r_gcn_cfg), "sage": (graphsage_reddit, r_sage_cfg),
        "gat": (gat_cora, r_gat_cfg), "meshgraphnet": (meshgraphnet, r_mgn_cfg)}
# K1 calls per forward: one a layer / step, GAT three a layer
K1_PER_LAYER = {"gcn": 1, "sage": 1, "gat": 3, "meshgraphnet": 1}


def padded_graph(seed, n=N, e=E_VALID, pad=E_PAD):
    """A padded edge list as the reference lays it out: valid edges sorted
    by destination (some nodes with none), then ``pad`` edges at the sink
    row ``n``; GCN's symmetric weights; node and edge features."""
    rng = np.random.default_rng(seed)
    dst = np.sort(rng.integers(0, n - 3, e))  # the last 3 nodes get no edge
    src = rng.integers(0, n, e)
    deg_s = np.bincount(src, minlength=n).astype(np.float32)
    deg_d = np.bincount(dst, minlength=n).astype(np.float32)
    w = 1.0 / np.sqrt(np.maximum(deg_s[src] * deg_d[dst], 1.0))
    return {
        "src": np.concatenate([src, np.full(pad, n)]).astype(np.int32),
        "dst": np.concatenate([dst, np.full(pad, n)]).astype(np.int32),
        "w": np.concatenate([w, np.zeros(pad)]).astype(np.float32),
        "rng": rng,
    }


def _close(got, want, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL, err_msg=what)


def _pair(kind, seed=0):
    """(port cfg, reference cfg, port params, reference params) of the
    SMOKE config of ``kind``, params drawn by the reference's init."""
    port_mod, ref_mod = CFGS[kind]
    rcfg, cfg = ref_mod.SMOKE, port_mod.SMOKE
    init = {"gcn": rg.gcn_init, "sage": rg.sage_init, "gat": rg.gat_init,
            "meshgraphnet": rg.mgn_init}[kind]
    rparams = init(jax.random.PRNGKey(seed), rcfg)
    tree = jax.tree_util.tree_map(np.asarray, rparams)
    return cfg, rcfg, convert.gnn_params_from_arrays(tree, cfg, torch_device="cpu"), rparams


def _forward(kind, params, cfg, feats, edge_feats, g, mod, plan=None):
    src, dst, n = g["src"], g["dst"], N
    kw = {} if mod is rg else {"plan": plan}
    if kind == "gcn":
        return mod.gcn_forward(params, feats, src, dst, g["w"], n, cfg, **kw)
    if kind == "sage":
        return mod.sage_forward(params, feats, src, dst, n, cfg, **kw)
    if kind == "gat":
        return mod.gat_forward(params, feats, src, dst, n, cfg, **kw)
    return mod.mgn_forward(params, feats, edge_feats, src, dst, n, cfg, **kw)


@pytest.mark.parametrize("kind", list(CFGS))
def test_smoke_forward_matches_reference(kind, monkeypatch):
    cfg, rcfg, params, rparams = _pair(kind)
    g = padded_graph(1)
    x = g["rng"].standard_normal((N, cfg.d_in)).astype(np.float32)
    ef = g["rng"].standard_normal((g["src"].size, 3)).astype(np.float32)
    want = _forward(kind, rparams, rcfg, x, ef, g, rg)
    calls = []
    real = gnn.segment_reduce_multi

    def counted(tp, values, monoids):
        calls.append(tuple(monoids))
        return real(tp, values, monoids)

    plan = gnn.edge_plan(g["src"], g["dst"], N, torch_device="cpu")
    monkeypatch.setattr(gnn, "segment_reduce_multi", counted)
    got = _forward(kind, params, cfg, torch.from_numpy(x), torch.from_numpy(ef), g, gnn,
                   plan)
    assert tuple(got.shape) == (N, cfg.d_out) == tuple(np.shape(want))
    _close(got, want, kind)
    assert len(calls) == K1_PER_LAYER[kind] * cfg.n_layers, calls
    # the plan built inside the forward gives the same bits
    again = _forward(kind, params, cfg, torch.from_numpy(x), torch.from_numpy(ef), g, gnn)
    assert torch.equal(got, again)


@pytest.mark.parametrize("kind", list(CFGS))
def test_init_shapes_match_reference(kind):
    port_mod, _ = CFGS[kind]
    cfg, _, converted, _ = _pair(kind)
    init = {"gcn": gnn.gcn_init, "sage": gnn.sage_init, "gat": gnn.gat_init,
            "meshgraphnet": gnn.mgn_init}[kind]
    own = init(torch.Generator().manual_seed(0), cfg)

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return (tuple(tree.shape), tree.dtype)

    assert shapes(own) == shapes(converted)
    if kind == "meshgraphnet":
        assert len(own["proc"]) == cfg.n_layers


def test_message_passing_primitives_match_reference():
    """``scatter_sum``, ``scatter_mean`` and ``edge_softmax`` on unsorted
    destinations with sink-row edges, each with the plan built from
    ``dst`` alone."""
    rng = np.random.default_rng(5)
    dst = rng.integers(0, N + 1, 200).astype(np.int32)  # some at the sink row N
    dst[:5] = N
    msg = rng.standard_normal((200, 6)).astype(np.float32)
    scores = rng.standard_normal((200, 3)).astype(np.float32)
    _close(gnn.scatter_sum(torch.from_numpy(msg), dst, N),
           rg.scatter_sum(msg, dst, N), "scatter_sum")
    _close(gnn.scatter_mean(torch.from_numpy(msg), dst, N),
           rg.scatter_mean(msg, dst, N), "scatter_mean")
    _close(gnn.edge_softmax(torch.from_numpy(scores), dst, N),
           rg.edge_softmax(scores, dst, N), "edge_softmax")


def test_edge_softmax_empty_segments_are_minus_inf_before_nan_to_num():
    """K1's max identity in an empty segment is -inf, as
    ``jax.ops.segment_max`` leaves it: a node with no incoming edge gets no
    softmax row, and nothing turns to NaN."""
    dst = np.array([0, 0, 2], np.int32)  # node 1 has no incoming edge
    plan = gnn.edge_plan(None, dst, 3, torch_device="cpu")
    m = gnn.segment_reduce_multi(plan.by_edge, torch.ones(3, 1), (0, 0, 1))
    assert m[1, 0].item() == float("-inf")
    alpha = gnn.edge_softmax(torch.tensor([[1.0], [2.0], [5.0]]), dst, 3, plan)
    assert torch.isfinite(alpha).all()
    assert alpha[2, 0].item() == 1.0


@pytest.mark.parametrize("k", [1, 2])
def test_khop_aggregate_is_bitwise_the_reference_on_integer_features(k):
    from repro.core.dbindex import build_dbindex as r_build
    from repro.core.engine_jax import plan_from_dbindex as r_plan
    from repro.core.windows import KHopWindow as RKHop
    from repro.graphs.generators import erdos_renyi as r_er

    from repro_torch.core.dbindex import build_dbindex
    from repro_torch.core.engine_torch import plan_from_dbindex
    from repro_torch.core.windows import KHopWindow
    from repro_torch.graphs.generators import erdos_renyi

    n, d = 250, 7
    x = np.random.default_rng(9).integers(0, 100, (n, d)).astype(np.float32)
    rplan = r_plan(r_build(r_er(n, 3.0, seed=3), RKHop(k), method="emc"))
    plan = plan_from_dbindex(build_dbindex(erdos_renyi(n, 3.0, seed=3), KHopWindow(k),
                                           method="emc"), torch_device="cpu")
    got = gnn.khop_aggregate(plan, torch.from_numpy(x))
    want = np.asarray(rg.khop_aggregate(rplan, x))
    assert got.shape == want.shape == (n, d)
    assert got.numpy().tobytes() == want.tobytes()


def test_configs_cut_for_each_shape_like_the_reference():
    from repro.configs.registry import GNN_SHAPES as R_SHAPES

    from repro_torch.configs.registry import GNN_SHAPES

    assert {k: (v.kind, v.dims) for k, v in GNN_SHAPES.items()} == \
        {k: (v.kind, v.dims) for k, v in R_SHAPES.items()}
    for kind, (port_mod, ref_mod) in CFGS.items():
        for shape in GNN_SHAPES.values():
            mine = port_mod.cfg_for(shape.dims)
            ref = ref_mod.cfg_for(shape.dims)
            assert dataclasses.asdict(mine) == dataclasses.asdict(ref), (kind, shape.name)

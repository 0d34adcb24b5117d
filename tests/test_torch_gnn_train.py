"""GNN training on the port (``repro_torch.launch.steps.gnn_loss`` /
``build_gnn_train`` and the message-passing Functions of
``repro_torch.models.gnn``) against the reference on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
port's params are the reference's ``*_init`` tree carried across
(``convert.gnn_params_from_arrays``).  The reference is its unsharded
``gnn_loss`` under ``jax.value_and_grad`` and its AdamW on
``cosine_schedule(1e-3, 100, 10_000)``.  On the CPU the port's sums are
K1's plain version over the graph's tile plans, forward and backward, and
the reference's are ``jax.ops.segment_sum``: float32 sums in another
order, so every gradient and updated param is held element by element
within ``TOL * (|ref| + rms(ref))``, ``TOL = 1e-5`` (rms over the whole
tensor), the loss and the gradient norm within ``rtol = 1e-5``.  The
graphs carry padding edges to the sink row, nodes with no incoming edge
and repeated sources.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.dbindex import build_dbindex as r_build_dbindex  # noqa: E402
from repro.core.engine_jax import plan_from_dbindex as r_plan  # noqa: E402
from repro.core.engine_jax import query_dbindex as r_query  # noqa: E402
from repro.core.windows import KHopWindow as RKHop  # noqa: E402
from repro.data.pipeline import NeighborSampler as RSampler  # noqa: E402
from repro.graphs.generators import erdos_renyi as r_er  # noqa: E402
from repro.launch import steps as rsteps  # noqa: E402
from repro.models import gnn as rg  # noqa: E402
from repro.optim.optimizers import adamw as r_adamw  # noqa: E402
from repro.optim.schedules import cosine_schedule as r_cosine  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import gnn  # noqa: E402
from repro_torch.optim.optimizers import adamw  # noqa: E402
from repro_torch.tree import flatten_with_paths, leaves  # noqa: E402

from test_torch_gnn import CFGS, N, _pair, padded_graph  # noqa: E402

TOL = 1e-5
KINDS = list(CFGS)
# K1 launches of one step with two layers (MeshGraphNet: per processor
# step): forward, and backward for a layer whose input needs a gradient
# (MeshGraphNet's backward recomputes each step's forward under its
# chunked remat: one sum more than its two gathers' transposes)
K1_FWD = {"gcn": 1, "sage": 1, "gat": 3, "meshgraphnet": 1}
K1_BWD = {"gcn": 1, "sage": 1, "gat": 4, "meshgraphnet": 3}


def k1_per_step(kind, n_layers):
    """(forward, backward) K1 launches of a step: GCN's and GraphSAGE's
    first layer reads the features, which need no gradient."""
    bwd_layers = n_layers - 1 if kind in ("gcn", "sage") else n_layers
    return K1_FWD[kind] * n_layers, K1_BWD[kind] * bwd_layers


def make_batch(kind, cfg, g, rng, n=N):
    b = {"feats": rng.standard_normal((n, cfg.d_in)).astype(np.float32),
         "edge_src": g["src"], "edge_dst": g["dst"]}
    if kind == "gcn":
        b["edge_w"] = g["w"]
    if kind == "meshgraphnet":
        b["edge_feats"] = rng.standard_normal((g["src"].size, 3)).astype(np.float32)
        b["targets"] = rng.standard_normal((n, cfg.d_out)).astype(np.float32)
    else:
        b["labels"] = rng.integers(0, cfg.d_out, n).astype(np.int32)
        b["label_mask"] = (rng.random(n) < 0.6).astype(np.float32)
    return b


def _close(got, want, what=""):
    """Each element within TOL * (|want| + rms(want))."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float64)
    rms = np.sqrt(np.mean(want ** 2)) if want.size else 0.0
    bad = np.abs(got - want) > TOL * (np.abs(want) + rms)
    assert not bad.any(), (what, np.abs(got - want).max(), rms)


def _tensors(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _dims(cfg, g):
    return dict(n=N, e=int(g["src"].size), d_feat=cfg.d_in, classes=cfg.d_out)


@pytest.mark.parametrize("kind", KINDS)
def test_gnn_step_matches_reference(kind):
    """Loss, every gradient, the gradient norm and the params after one
    AdamW step against ``jax.value_and_grad(gnn_loss)`` and the
    reference's AdamW, from the reference's params."""
    cfg, rcfg, params, rparams = _pair(kind)
    g = padded_graph(1)
    b = make_batch(kind, cfg, g, g["rng"])
    rb = {k: jnp.asarray(v) for k, v in b.items()}
    loss, grads = jax.value_and_grad(lambda p: rsteps.gnn_loss(p, rb, rcfg, N))(rparams)
    ropt = r_adamw(r_cosine(1e-3, 100, 10_000))
    rnew, _, rgnorm = ropt.update(grads, ropt.init(rparams), rparams)

    built = steps.build_gnn_train(cfg, None, _dims(cfg, g), torch_device="cpu")
    tb = _tensors(b)
    plan = gnn.edge_plan(b["edge_src"], b["edge_dst"], N, torch_device="cpu")
    got_loss, got_grads = steps.gnn_value_and_grad(params, tb, cfg, N, plan)
    opt_state = adamw(1e-3).init(params)
    new, state, out = built.fn(params, opt_state, tb, plan=plan)

    np.testing.assert_allclose(float(got_loss), float(loss), rtol=TOL)
    np.testing.assert_allclose(float(out["loss"]), float(loss), rtol=TOL)
    np.testing.assert_allclose(float(out["gnorm"]), float(rgnorm), rtol=TOL)
    want_grads = convert.gnn_params_from_arrays(jax.tree_util.tree_map(np.asarray, grads),
                                                cfg, torch_device="cpu")
    want_new = convert.gnn_params_from_arrays(jax.tree_util.tree_map(np.asarray, rnew),
                                              cfg, torch_device="cpu")
    paths = [p for p, _ in flatten_with_paths(params)]
    for path, x, y in zip(paths, leaves(got_grads), leaves(want_grads)):
        assert float(y.abs().max()) > 0 or kind == "gat", path
        _close(x, y.numpy(), f"grad {path}")
    for path, x, y in zip(paths, leaves(new), leaves(want_new)):
        _close(x, y.numpy(), f"param {path}")
    assert int(state.step) == 1


@pytest.mark.parametrize("kind", ["gcn", "meshgraphnet"])
def test_adamw_state_carries_across(kind):
    """The reference's params and AdamW state after one step
    (``convert.adamw_state_from_arrays``; MeshGraphNet's stacked ``proc``
    moments split per step, bf16 kept) continue on the port: its second
    step against the reference's second step."""
    cfg, rcfg, _, rparams = _pair(kind)
    g = padded_graph(1)
    b = make_batch(kind, cfg, g, g["rng"])
    rb = {k: jnp.asarray(v) for k, v in b.items()}
    ropt = r_adamw(r_cosine(1e-3, 100, 10_000))
    rstate = ropt.init(rparams)
    for _ in range(2):
        grads = jax.grad(lambda p: rsteps.gnn_loss(p, rb, rcfg, N))(rparams)
        if int(rstate.step) == 1:
            carried = (rparams, rstate)
        rparams, rstate, _ = ropt.update(grads, rstate, rparams)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    params = convert.gnn_params_from_arrays(to_np(carried[0]), cfg, torch_device="cpu")
    state = convert.adamw_state_from_arrays(carried[1].step, to_np(carried[1].mu),
                                            to_np(carried[1].nu), cfg.n_layers,
                                            torch_device="cpu", stacked="proc")
    assert all(m.dtype == torch.bfloat16 for m in leaves(state.mu))
    assert [tuple(m.shape) for m in leaves(state.nu)] == [tuple(p.shape) for p in leaves(params)]
    built = steps.build_gnn_train(cfg, None, _dims(cfg, g), torch_device="cpu")
    new, state, _ = built.fn(params, state, _tensors(b))
    assert int(state.step) == 2
    want = convert.gnn_params_from_arrays(to_np(rparams), cfg, torch_device="cpu")
    for (path, x), y in zip(flatten_with_paths(new), leaves(want)):
        _close(x, y.numpy(), path)


def plain_multi(tp, values, monoids):
    """K1's plain version, called straight so that autograd records it."""
    from repro_torch.kernels.segment_reduce.segment_reduce import segment_reduce_plain

    return segment_reduce_plain(values.float(), tp.gather_padded, tp.seg_tiles,
                                monoids=tuple(monoids), num_out_tiles=tp.num_out_tiles,
                                ts=tp.ts)[: tp.num_segments]


def _plain(monkeypatch):
    """The models' message passing without the Functions: ``index_select``
    and K1's plain version under PyTorch's own autograd."""
    monkeypatch.setattr(gnn, "_record", lambda *ts: False)
    monkeypatch.setattr(gnn, "segment_reduce_multi", plain_multi)


@pytest.mark.parametrize("kind", KINDS)
def test_k1_backward_matches_plain_autograd(kind, monkeypatch):
    """The Functions' backward (K1 over the source-sorted layout, the
    gather ``dout[dst]``) against autograd through ``index_select`` and
    ``index_add_``, and bitwise across two backward passes."""
    cfg, _, params, _ = _pair(kind, seed=3)
    g = padded_graph(4)
    tb = _tensors(make_batch(kind, cfg, g, g["rng"]))
    plan = gnn.edge_plan(g["src"], g["dst"], N, torch_device="cpu")
    loss, grads = steps.gnn_value_and_grad(params, tb, cfg, N, plan)
    again = steps.gnn_value_and_grad(params, tb, cfg, N, plan)
    assert torch.equal(loss, again[0])
    for x, y in zip(leaves(grads), leaves(again[1])):
        assert torch.equal(x, y)
    _plain(monkeypatch)
    p_loss, p_grads = steps.gnn_value_and_grad(params, tb, cfg, N, plan)
    np.testing.assert_allclose(float(loss), float(p_loss), rtol=TOL)
    for (path, x), y in zip(flatten_with_paths(grads), leaves(p_grads)):
        _close(x, y.numpy(), path)


@pytest.mark.parametrize("kind", KINDS)
def test_k1_launches_per_step(kind, monkeypatch):
    """K1 calls in the forward and in the backward of a step, as the model
    docstring counts them: every sum of the backward is K1."""
    cfg, _, params, _ = _pair(kind)
    g = padded_graph(1)
    tb = _tensors(make_batch(kind, cfg, g, g["rng"]))
    plan = gnn.edge_plan(g["src"], g["dst"], N, torch_device="cpu")
    calls = []
    real = gnn.segment_reduce_multi

    def counted(tp, values, monoids):
        calls.append(tuple(monoids))
        return real(tp, values, monoids)

    monkeypatch.setattr(gnn, "segment_reduce_multi", counted)
    live = [p.detach().requires_grad_() for p in leaves(params)]
    from repro_torch.tree import unflatten

    loss = steps.gnn_loss(unflatten(params, live), tb, cfg, N, plan=plan)
    fwd = len(calls)
    torch.autograd.grad(loss, live)
    assert (fwd, len(calls) - fwd) == k1_per_step(kind, cfg.n_layers)


@pytest.mark.parametrize("chunk", [1, 2, 3])
def test_mgn_remat_chunk_gradients_bitwise(chunk, monkeypatch):
    """MeshGraphNet's chunked remat on the 3-step SMOKE config: chunk 3 is
    one checkpoint over the three processor steps, 1 and 2 (which does not
    divide 3, so the reference takes one a step) three.  The loss and every
    gradient equal the default chunk's to the bit, within ``TOL`` of the
    reference's ``jax.grad`` of ``gnn_loss``; K1 runs 3 times forward and
    9 times backward (the recomputed forward's 3 among them)."""
    cfg, rcfg, params, rparams = _pair("meshgraphnet")
    assert cfg.n_layers == 3
    g = padded_graph(1)
    b = make_batch("meshgraphnet", cfg, g, g["rng"])
    rb = {k: jnp.asarray(v) for k, v in b.items()}
    want = jax.grad(lambda p: rsteps.gnn_loss(p, rb, rcfg, N))(rparams)
    want = convert.gnn_params_from_arrays(jax.tree_util.tree_map(np.asarray, want), cfg,
                                          torch_device="cpu")
    tb = _tensors(b)
    plan = gnn.edge_plan(b["edge_src"], b["edge_dst"], N, torch_device="cpu")
    from repro_torch.tree import unflatten

    def grads(c):
        live = [p.detach().requires_grad_() for p in leaves(params)]
        out = gnn.mgn_forward(unflatten(params, live), tb["feats"], tb["edge_feats"],
                              tb["edge_src"], tb["edge_dst"], N, cfg, remat_chunk=c,
                              plan=plan)
        loss = torch.mean(torch.square(out - tb["targets"]))
        return loss, torch.autograd.grad(loss, live)

    base = grads(3)
    calls, checkpoints = [], []
    real, real_ckpt = gnn.segment_reduce_multi, gnn.checkpoint

    def counted(tp, values, monoids):
        calls.append(tuple(monoids))
        return real(tp, values, monoids)

    def counted_ckpt(*a, **kw):
        checkpoints.append(len(a[3]))
        return real_ckpt(*a, **kw)

    monkeypatch.setattr(gnn, "segment_reduce_multi", counted)
    monkeypatch.setattr(gnn, "checkpoint", counted_ckpt)
    loss, got = grads(chunk)
    assert checkpoints == ([3] if chunk == 3 else [1, 1, 1])
    assert len(calls) == 3 + 9
    assert torch.equal(loss, base[0])
    paths = [p for p, _ in flatten_with_paths(params)]
    for path, x, y, w in zip(paths, got, base[1], leaves(want)):
        assert x.numpy().tobytes() == y.numpy().tobytes(), path
        _close(x, w.numpy(), f"grad {path}")


def test_source_layout_is_built_once_on_the_first_tracked_call():
    """A forward with no gradient builds nothing and leaves ``plan_nbytes``
    as it was; the first backward builds the source-sorted layout (its
    rows: every valid edge, grouped by source, ``by_src_dst`` gathering
    each row's destination), and later ones reuse it."""
    cfg, _, params, _ = _pair("sage")
    g = padded_graph(2)
    tb = _tensors(make_batch("sage", cfg, g, g["rng"]))
    plan = gnn.edge_plan(g["src"], g["dst"], N, torch_device="cpu")
    before = plan.plan_nbytes()
    with torch.no_grad():
        steps.gnn_loss(params, tb, cfg, N, plan=plan)
    assert plan.source_nbytes() == 0 and not plan._source
    steps.gnn_value_and_grad(params, tb, cfg, N, plan)
    by_src_edge, by_src_dst = plan.source()
    assert plan.source() is plan._source["layouts"]
    steps.gnn_value_and_grad(params, tb, cfg, N, plan)
    assert plan.source()[0] is by_src_edge
    assert plan.plan_nbytes() == before and plan.source_nbytes() > 0
    seg = by_src_edge.seg_tiles.reshape(-1).numpy()
    ok = seg >= 0
    eid = by_src_edge.gather_padded.numpy()[ok]
    src = np.minimum(g["src"], N - 1)
    valid = np.flatnonzero(g["dst"] < N)
    assert sorted(eid.tolist()) == valid.tolist()
    assert np.array_equal(seg[ok], src[eid])
    assert np.array_equal(by_src_dst.seg_tiles, by_src_edge.seg_tiles)
    assert np.array_equal(by_src_dst.gather_padded.numpy()[ok], g["dst"][eid])


def test_gat_gradients_ignore_the_detached_max():
    """GAT's softmax takes K1's max on detached scores; the reference
    differentiates through ``segment_max``.  Shifting every score of a node
    leaves the softmax and its gradient as they were, so the two agree
    (``test_gnn_step_matches_reference[gat]`` holds every gradient); here
    the gradient of the softmax itself against the reference's."""
    rng = np.random.default_rng(11)
    dst = np.sort(rng.integers(0, N - 2, 120)).astype(np.int32)
    dst = np.concatenate([dst, np.full(8, N, np.int32)])
    scores = rng.standard_normal((dst.size, 3)).astype(np.float32) * 4
    w = rng.standard_normal((dst.size, 3)).astype(np.float32)
    valid = (dst < N)[:, None]

    def r_fn(s):
        a = rg.edge_softmax(jnp.where(valid, s, -1e30), jnp.minimum(dst, N - 1), N)
        return jnp.sum(jnp.where(valid, a, 0) * w)

    want = jax.grad(r_fn)(jnp.asarray(scores))
    s = torch.from_numpy(scores).requires_grad_()
    plan = gnn.edge_plan(None, dst, N, torch_device="cpu")
    a = gnn.edge_softmax(s, dst, N, plan)
    (got,) = torch.autograd.grad(torch.sum(torch.where(torch.from_numpy(valid), a, 0.0)
                                           * torch.from_numpy(w)), s)
    _close(got[dst < N], np.asarray(want)[dst < N], "d scores")


def test_tracked_input_still_raises_without_a_route():
    """K1 calls with no backward route raise on a tracked input on the CPU
    as on the card: min/max columns and ``khop_aggregate``."""
    from repro_torch.core.dbindex import build_dbindex
    from repro_torch.core.engine_torch import plan_from_dbindex
    from repro_torch.core.windows import KHopWindow
    from repro_torch.graphs.generators import erdos_renyi

    plan = gnn.edge_plan(None, np.array([0, 0, 2], np.int32), 3, torch_device="cpu")
    x = torch.ones((3, 2), requires_grad=True)
    with pytest.raises(RuntimeError, match="requires grad"):
        gnn.segment_reduce_multi(plan.by_edge, x, (0, 1, 1))
    with torch.no_grad():
        gnn.segment_reduce_multi(plan.by_edge, x, (0, 1, 1))
    dplan = plan_from_dbindex(build_dbindex(erdos_renyi(60, 3.0, seed=1), KHopWindow(2),
                                            method="emc"), torch_device="cpu")
    feats = torch.ones((60, 3), requires_grad=True)
    with pytest.raises(RuntimeError, match="requires grad"):
        gnn.khop_aggregate(dplan, feats)
    assert gnn.khop_aggregate(dplan, feats.detach()).shape == (60, 3)


def test_sage_minibatch_loop_with_window_features_matches_reference():
    """``examples/gnn_train.py``'s loop at a few hundred vertices: DBIndex
    2-hop window sums as extra input features, GraphSAGE over the
    ``NeighborSampler``'s sampled subgraphs, the mean NLL of the targets,
    AdamW at 1e-2; the port's losses over six steps against the
    reference's, from the same params, samples and features."""
    from repro_torch.core.dbindex import build_dbindex
    from repro_torch.core.engine_torch import plan_from_dbindex
    from repro_torch.core.windows import KHopWindow
    from repro_torch.data.pipeline import NeighborSampler
    from repro_torch.graphs.generators import erdos_renyi

    n, targets, steps_n = 300, 16, 6
    rng = np.random.default_rng(0)
    feats = rng.integers(-5, 6, (n, 8)).astype(np.float32)
    labels = rng.integers(0, 5, n).astype(np.int32)
    rgr, pgr = r_er(n, 6.0, seed=6), erdos_renyi(n, 6.0, seed=6)
    want_w = np.asarray(r_query(r_plan(r_build_dbindex(rgr, RKHop(2), method="emc")),
                                feats, "sum", use_pallas=False))
    got_w = gnn.khop_aggregate(plan_from_dbindex(build_dbindex(pgr, KHopWindow(2),
                                                               method="emc"),
                                                 torch_device="cpu"),
                               torch.from_numpy(feats)).numpy()
    assert got_w.tobytes() == want_w.tobytes()  # integer features: exact
    x = np.concatenate([feats, want_w / (1 + want_w.std())], axis=1)

    rcfg = rg.GNNConfig(name="sage", kind="sage", n_layers=2, d_in=x.shape[1],
                        d_hidden=16, d_out=5)
    cfg = gnn.GNNConfig(name="sage", kind="sage", n_layers=2, d_in=x.shape[1],
                        d_hidden=16, d_out=5)
    rparams = rg.sage_init(jax.random.PRNGKey(0), rcfg)
    params = convert.gnn_params_from_arrays(jax.tree_util.tree_map(np.asarray, rparams),
                                            cfg, torch_device="cpu")
    ropt, opt = r_adamw(1e-2), adamw(1e-2)
    rstate, state = ropt.init(rparams), opt.init(params)
    rsam, sam = RSampler(rgr, fanouts=(5, 3)), NeighborSampler(pgr, fanouts=(5, 3))

    def r_loss(p, fs, es, ed, y, n_sub):
        logits = rg.sage_forward(p, fs, es, ed, n_sub, rcfg)[:targets].astype(jnp.float32)
        lse = jax.nn.logsumexp(logits, axis=-1)
        return jnp.mean(lse - jnp.take_along_axis(logits, y[:, None], axis=-1)[:, 0])

    for it in range(steps_n):
        rsub, sub = rsam.sample(targets), sam.sample(targets)
        for k in ("node_ids", "edge_src", "edge_dst"):
            assert np.array_equal(rsub[k], sub[k]), k
        n_sub = sub["sub_n"]
        y = labels[sub["node_ids"][:targets]]
        fs = x[sub["node_ids"]]
        want, rgrads = jax.value_and_grad(r_loss)(rparams, jnp.asarray(fs),
                                                  rsub["edge_src"], rsub["edge_dst"],
                                                  jnp.asarray(y), n_sub)
        rparams, rstate, _ = ropt.update(rgrads, rstate, rparams)
        batch = {"feats": torch.from_numpy(fs), "edge_src": torch.from_numpy(sub["edge_src"]),
                 "edge_dst": torch.from_numpy(sub["edge_dst"]),
                 "labels": torch.from_numpy(np.pad(y, (0, n_sub - targets))),
                 "label_mask": torch.from_numpy((np.arange(n_sub) < targets)
                                                .astype(np.float32))}
        plan = gnn.edge_plan(sub["edge_src"], sub["edge_dst"], n_sub, torch_device="cpu")
        loss, grads = steps.gnn_value_and_grad(params, batch, cfg, n_sub, plan)
        params, state, _ = opt.update(grads, state, params)
        np.testing.assert_allclose(float(loss), float(want), rtol=1e-4, err_msg=str(it))

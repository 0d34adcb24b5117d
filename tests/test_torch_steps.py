"""The port's step builders (``repro_torch.launch.steps``) and mesh
(``repro_torch.launch.mesh``) against the reference on the CPU.

* ``build_gnn_train``: the argument stand-ins and specs equal the
  reference's; over a one-device mesh the step is bitwise the one-device
  step; over two and three gloo ranks (edges and node rows sharded, at
  node counts the world divides and does not) the loss, gradients and
  updated params agree with one device within ``TOL * (|w1| + rms(w1))``,
  ``TOL = 1e-5`` (float32 sums in another order), and the ranks agree
  with each other to the bit.
* ``build_gwq_step``: bitwise the reference's compiled step on integer
  values, at 1 x 1 in this process and at 2 x 2 (four gloo ranks against
  the reference on four forced host devices), with and without
  ``boundary_frac``; with it, each rank against the reference's shard on
  the device at the same mesh coordinate.

World sizes above 1 run as spawned ranks of this file (``python
tests/test_torch_steps.py <worker> <rank> <world> <store> <out>``); the
reference at 2 x 2 runs in a subprocess of its own.
"""

import datetime
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT_S = 240
TOL = 1e-5
KINDS = ("gcn", "sage", "gat", "meshgraphnet")
N_NODES, E_VALID = 40, 150
GWQ = dict(n=500, nb=200, m=3000, l=800)


# ---------------------------------------------------------------------- #
#  cases shared by the test process and the spawned ranks
# ---------------------------------------------------------------------- #
def gnn_case(kind, n=N_NODES, world=2):
    """(cfg, params, whole batch as NumPy, dims) of ``kind``'s SMOKE config
    on ``n`` nodes and a padded graph of ``E_VALID`` valid edges, the rest
    at the sink row up to a multiple of 128 x ``world`` (256 for worlds 1
    and 2; the last 3 nodes with no incoming edge), params from the port's
    init on a CPU generator seeded with 0."""
    from repro_torch.configs import gat_cora, gcn_cora, graphsage_reddit, meshgraphnet
    from repro_torch.models import gnn

    cfg = {"gcn": gcn_cora, "sage": graphsage_reddit, "gat": gat_cora,
           "meshgraphnet": meshgraphnet}[kind].SMOKE
    init = {"gcn": gnn.gcn_init, "sage": gnn.sage_init, "gat": gnn.gat_init,
            "meshgraphnet": gnn.mgn_init}[kind]
    params = init(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(7)
    e = E_VALID
    pad = -(-e // (128 * world)) * 128 * world - e
    dst = np.sort(rng.integers(0, n - 3, e))
    src = rng.integers(0, n, e)
    deg_s = np.bincount(src, minlength=n).astype(np.float32)
    deg_d = np.bincount(dst, minlength=n).astype(np.float32)
    w = 1.0 / np.sqrt(np.maximum(deg_s[src] * deg_d[dst], 1.0))
    b = {"feats": rng.standard_normal((n, cfg.d_in)).astype(np.float32),
         "edge_src": np.concatenate([src, np.full(pad, n)]).astype(np.int32),
         "edge_dst": np.concatenate([dst, np.full(pad, n)]).astype(np.int32)}
    if kind == "gcn":
        b["edge_w"] = np.concatenate([w, np.zeros(pad)]).astype(np.float32)
    if kind == "meshgraphnet":
        b["edge_feats"] = rng.standard_normal((e + pad, 3)).astype(np.float32)
        b["targets"] = rng.standard_normal((n, cfg.d_out)).astype(np.float32)
    else:
        b["labels"] = rng.integers(0, cfg.d_out, n).astype(np.int32)
        b["label_mask"] = (rng.random(n) < 0.6).astype(np.float32)
    return cfg, params, b, dict(n=n, e=e, d_feat=cfg.d_in, classes=cfg.d_out)


def gnn_record(kind, mesh, n=N_NODES, world=2) -> dict:
    """One step of ``build_gnn_train`` on this rank of ``gnn_case(kind, n,
    world)``: loss, gnorm, every gradient and every updated param, by
    name."""
    from repro_torch.launch import steps
    from repro_torch.optim.optimizers import adamw
    from repro_torch.tree import flatten_with_paths

    cfg, params, batch, dims = gnn_case(kind, n, world)
    built = steps.build_gnn_train(cfg, mesh, dims, torch_device="cpu")
    p, o, b = built.shard(params, adamw(1e-3).init(params), batch)
    plan = built.plan(p, o, b)
    loss, grads = steps.gnn_value_and_grad(p, b, cfg, dims["n"], plan)
    new, _, out = built.fn(p, o, b, plan=plan)
    rec = {f"{kind}/loss": loss.numpy(), f"{kind}/gnorm": out["gnorm"].numpy(),
           f"{kind}/step_loss": out["loss"].numpy()}
    rec.update({f"{kind}/grad/{k}": v.numpy() for k, v in flatten_with_paths(grads)})
    rec.update({f"{kind}/param/{k}": v.numpy() for k, v in flatten_with_paths(new)})
    return rec


def gwq_rows(ndev: int, seed: int = 3):
    """(p1g, p1s, p2g, p2s, vals) of a seeded plan at ``GWQ``'s dims, the
    rows padded (segment -1) to the reference's multiple of 128 x ndev;
    integer values in [0, 100)."""
    rng = np.random.default_rng(seed)
    n, nb, m, l = GWQ["n"], GWQ["nb"], GWQ["m"], GWQ["l"]
    m_pad, l_pad = -(-m // (128 * ndev)) * 128 * ndev, -(-l // (128 * ndev)) * 128 * ndev
    p1s = np.full(m_pad, -1, np.int32)
    p1s[:m] = np.sort(rng.integers(0, nb, m))
    p1g = np.zeros(m_pad, np.int32)
    p1g[:m] = rng.integers(0, n, m)
    p2s = np.full(l_pad, -1, np.int32)
    p2s[:l] = np.sort(rng.integers(0, n, l))
    p2g = np.zeros(l_pad, np.int32)
    p2g[:l] = rng.integers(0, nb, l)
    return p1g, p1s, p2g, p2s, rng.integers(0, 100, n).astype(np.float32)


def _init(rank, world, store):
    import torch.distributed as dist

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))


def _worker_gnn(rank, world, store, out, n):
    from repro_torch.launch.mesh import make_debug_mesh

    _init(rank, world, store)
    mesh = make_debug_mesh(world, 1, "cpu")
    rec = {}
    for kind in KINDS:
        rec.update(gnn_record(kind, mesh, int(n), world))
    np.savez(f"{out}.{rank}.npz", **rec)


def _worker_gwq(rank, world, store, out):
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_debug_mesh

    _init(rank, world, store)
    mesh = make_debug_mesh(2, world // 2, "cpu")
    rows = gwq_rows(2)
    rec = {}
    for bf in (0, 10):
        dims = dict(GWQ, boundary_frac=bf) if bf else dict(GWQ)
        rec[f"bf{bf}"] = steps.build_gwq_step(dims, mesh, torch_device="cpu").run(
            *rows).numpy()
    rec["coord"] = np.asarray(mesh.get_coordinate())
    np.savez(f"{out}.{rank}.npz", **rec)


def _worker_ref_gwq(rank, world, store, out):
    """The reference's compiled ``build_gwq_step`` on a 2 x 2 mesh of four
    forced host devices: each device's result by mesh coordinate."""
    import jax

    from repro.launch import steps as rsteps
    from repro.launch.mesh import make_debug_mesh as r_mesh

    mesh = r_mesh(2, 2)
    rows = gwq_rows(2)
    rec = {}
    for bf in (0, 10):
        dims = dict(GWQ, boundary_frac=bf) if bf else dict(GWQ)
        built = rsteps.build_gwq_step(dims, mesh)
        with mesh:
            got = built.lower(mesh).compile()(*rows)
        by_dev = {s.device: np.asarray(s.data) for s in got.addressable_shards}
        for idx in np.ndindex(mesh.devices.shape):
            rec[f"bf{bf}_{idx[0]}_{idx[1]}"] = by_dev[mesh.devices[idx]]
    assert len(jax.devices()) == 4
    np.savez(f"{out}.npz", **rec)


_WORKERS = {"gnn": _worker_gnn, "gwq": _worker_gwq, "ref_gwq": _worker_ref_gwq}


def _spawn(worker: str, world: int, tmp_path, env_extra=None, extra=()) -> list:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1",
           **(env_extra or {})}
    args = [str(tmp_path / f"store_{worker}"), str(tmp_path / f"out_{worker}"),
            *map(str, extra)]
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
    return [tmp_path / f"out_{worker}.{r}" for r in range(world)]


@pytest.fixture
def one_device_mesh():
    """A 1 x 1 CPU mesh over a world of one (started here if no group is)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh

    started = not dist.is_initialized()
    yield make_debug_mesh(1, 1, "cpu")
    if started and dist.is_initialized():
        dist.destroy_process_group()


def _close(got, want, what):
    rms = np.sqrt(np.mean(np.square(want, dtype=np.float64))) if want.size else 0.0
    bad = np.abs(got.astype(np.float64) - want) > TOL * (np.abs(want) + rms)
    assert not bad.any(), (what, np.abs(got - want).max(), rms)


# ---------------------------------------------------------------------- #
#  tests
# ---------------------------------------------------------------------- #
def test_dp_axes_and_debug_mesh(one_device_mesh):
    from repro_torch.launch.mesh import dp_axes_of, make_debug_mesh

    assert one_device_mesh.mesh_dim_names == ("data", "model")
    assert dp_axes_of(one_device_mesh) == ("data",)

    class Named:
        mesh_dim_names = ("pod", "data", "model")

    assert dp_axes_of(Named()) == ("pod", "data")
    with pytest.raises(ValueError):
        make_debug_mesh(2, 2, "cpu")  # a world of one


@pytest.mark.parametrize("shape", ["full_graph_sm", "minibatch_lg", "ogb_products", "molecule"])
@pytest.mark.parametrize("arch", ["gcn-cora", "graphsage-reddit", "gat-cora", "meshgraphnet"])
def test_gnn_stand_ins_and_specs_match_reference(arch, shape, one_device_mesh):
    """The step's argument stand-ins (meta tensors, nothing allocated) have
    the reference's shapes and dtypes at every GNN shape, and its specs
    are the reference's shardings' specs."""
    import importlib

    import jax

    from repro.configs import registry as r_registry
    from repro.launch import steps as rsteps

    from repro_torch.configs import registry
    from repro_torch.convert import gnn_params_from_arrays
    from repro_torch.launch import steps
    from repro_torch.tree import leaves

    dims = registry.GNN_SHAPES[shape].dims
    rcfg = importlib.import_module(r_registry.ARCH_MODULES[arch]).cfg_for(dims)
    cfg = importlib.import_module(registry.ARCH_MODULES[arch]).cfg_for(dims)
    ref = rsteps.build_gnn_train(rcfg, jax.make_mesh((1, 1), ("data", "model")), dims)
    got = steps.build_gnn_train(cfg, one_device_mesh, dims, torch_device="cpu")
    params_s, opt_s, batch = got.args
    assert all(t.device.type == "meta" for t in leaves(got.args))
    r_params, _, r_batch = ref.args
    assert sorted(batch) == sorted(r_batch)
    for k in batch:
        assert tuple(batch[k].shape) == r_batch[k].shape, k
        assert str(batch[k].dtype).split(".")[1] == str(r_batch[k].dtype), k
        assert tuple(got.in_specs[2][k]) == tuple(ref.in_shardings[2][k].spec), k
    want = gnn_params_from_arrays(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), r_params), cfg, torch_device="cpu")
    assert [tuple(t.shape) for t in leaves(params_s)] == \
        [tuple(t.shape) for t in leaves(want)]
    assert [tuple(t.shape) for t in leaves(opt_s.mu)] == \
        [tuple(t.shape) for t in leaves(want)]
    assert all(tuple(s) == () for s in leaves(got.in_specs[0]))


def test_reference_gnn_train_does_not_lower_r11():
    """R11 (reference fault): the reference's ``build_gnn_train`` cannot
    lower on this JAX on a 1 x 1 mesh; ``gnn._constrain`` hands
    ``with_sharding_constraint`` a spec over the mesh's explicit axes.  The
    port's GNN step is held against the reference's unsharded
    ``gnn_loss`` + AdamW instead (``tests/test_torch_gnn_train.py``)."""
    import jax

    from repro.configs import gcn_cora
    from repro.launch import steps as rsteps

    mesh = jax.make_mesh((1, 1), ("data", "model"))
    built = rsteps.build_gnn_train(gcn_cora.SMOKE, mesh,
                                   dict(n=40, e=150, d_feat=12, classes=3))
    with pytest.raises(ValueError, match="Auto axes"):
        built.lower(mesh)


def test_gnn_world1_mesh_step_is_bitwise_the_one_device_step(one_device_mesh):
    """Over a mesh of one device the step has no collective: loss,
    gradients and updated params equal ``mesh=None``'s to the bit."""
    for kind in KINDS:
        a, b = gnn_record(kind, one_device_mesh), gnn_record(kind, None)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].tobytes() == b[k].tobytes(), k


def node_rows_collectives(kind, n_layers):
    """(all-gathers, reduce-scatters) of one node-sharded step: forward, a
    gather of each layer's input rows but the features (every layer's for
    GAT and MeshGraphNet) and a reduce-scatter of each layer's sums;
    backward, the other collective of each pair whose input needs a
    gradient (not GCN's and GraphSAGE's first sums, of the features);
    MeshGraphNet's recomputed forward reissues its pair a step."""
    if kind in ("gcn", "sage"):
        return 2 * (n_layers - 1), 2 * n_layers - 1
    if kind == "gat":
        return 2 * n_layers, 2 * n_layers
    return 3 * n_layers, 3 * n_layers


@pytest.mark.parametrize("kind", KINDS)
def test_gnn_world1_node_rows_step_is_bitwise_the_one_device_step(kind, one_device_mesh,
                                                                  monkeypatch):
    """An edge plan over the world of one takes the node-sharded path (the
    all-gathers, the reduce-scatters, every param through f), where one
    rank owns every row: loss, gnorm and updated params and moments equal
    the group-less plan's to the bit, and the step issues each collective
    where the data flow puts it (MeshGraphNet's remat reissues its pair in
    the backward)."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.launch import steps
    from repro_torch.models import gnn
    from repro_torch.optim.optimizers import adamw
    from repro_torch.tree import leaves

    cfg, params, batch, dims = gnn_case(kind)
    built = steps.build_gnn_train(cfg, None, dims, torch_device="cpu")
    p, o, b = built.shard(params, adamw(1e-3).init(params), batch)
    plan = built.plan(p, o, b)
    want = built.fn(p, o, b, plan=plan)
    counts = {"all_gather": 0, "reduce_scatter": 0}

    def counted(name, real):
        def call(x, rows):
            counts[name] += 1
            return real(x, rows)
        return call

    for name in counts:
        monkeypatch.setattr(gnn, f"_{name}", counted(name, getattr(gnn, f"_{name}")))
    got = built.fn(p, o, b, plan=dataclasses.replace(plan, group=dist.group.WORLD))
    assert tuple(counts.values()) == node_rows_collectives(kind, cfg.n_layers)
    assert len(leaves(got)) == len(leaves(want))
    assert all(torch.equal(x, y) for x, y in zip(leaves(got), leaves(want)))


@pytest.mark.parametrize("world,n", [(2, N_NODES), (2, 41), (3, 41)],
                         ids=["w2-n40", "w2-n41", "w3-n41"])
def test_gnn_world2_edge_sharded_matches_world1(world, n, tmp_path):
    """``world`` gloo ranks, each on its share of the edges (at world 3
    the last rank's edges are all padding) and of the ``n`` node rows
    (``ceil(n / world)`` each, fewer on the last rank where the world does
    not divide ``n``): every rank holds the same loss, gradients and
    params to the bit, within ``TOL`` of one device on the same graph."""
    outs = _spawn("gnn", world, tmp_path, extra=(n,))
    ranks = [dict(np.load(f"{p}.npz")) for p in outs]
    for other in ranks[1:]:
        assert ranks[0].keys() == other.keys()
        for k in ranks[0]:
            assert ranks[0][k].tobytes() == other[k].tobytes(), k
    want = {}
    for kind in KINDS:
        want.update(gnn_record(kind, None, n, world))
    assert want.keys() == ranks[0].keys()
    for k in want:
        if k.endswith("loss") or k.endswith("gnorm"):
            np.testing.assert_allclose(ranks[0][k], want[k], rtol=TOL, err_msg=k)
        else:
            _close(ranks[0][k], want[k], k)


@pytest.mark.parametrize("bf", [0, 10])
def test_gwq_1x1_bitwise_reference(bf, one_device_mesh):
    import jax

    from repro.launch import steps as rsteps
    from repro.launch.mesh import make_debug_mesh as r_mesh

    from repro_torch.launch import steps

    dims = dict(GWQ, boundary_frac=bf) if bf else dict(GWQ)
    rows = gwq_rows(1)
    mesh = r_mesh(1, 1)
    ref = rsteps.build_gwq_step(dims, mesh)
    with mesh:
        want = np.asarray(ref.lower(mesh).compile()(*rows))
    built = steps.build_gwq_step(dims, one_device_mesh, torch_device="cpu")
    for a, r in zip(built.args, ref.args):
        assert a.device.type == "meta" and tuple(a.shape) == r.shape
    assert [tuple(s) for s in built.in_specs] == [tuple(s.spec) for s in ref.in_shardings]
    got = built.run(*rows)
    assert got.numpy().tobytes() == want.tobytes()
    again = built.fn(*built.shard(*rows), plan=built.plan(*built.shard(*rows)))
    assert torch.equal(got, again)
    assert jax.devices()[0].platform == "cpu"


def test_gwq_2x2_bitwise_reference(tmp_path):
    """Four gloo ranks on a 2 x 2 mesh (rows over ``data``) against the
    reference on four forced host devices, with and without
    ``boundary_frac``: each rank bitwise the reference's result on the
    device at its mesh coordinate."""
    ref = subprocess.Popen(
        [sys.executable, __file__, "ref_gwq", "0", "1", str(tmp_path / "rs"),
         str(tmp_path / "ref")], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
             "XLA_FLAGS": "--xla_force_host_platform_device_count=4"})
    try:
        outs = _spawn("gwq", 4, tmp_path)
        _, err = ref.communicate(timeout=SPAWN_TIMEOUT_S)
    finally:
        ref.kill()
    assert ref.returncode == 0, err[-4000:]
    want = dict(np.load(tmp_path / "ref.npz"))
    coords = set()
    for p in outs:
        got = dict(np.load(f"{p}.npz"))
        i, j = (int(c) for c in got["coord"])
        coords.add((i, j))
        for bf in (0, 10):
            assert got[f"bf{bf}"].tobytes() == want[f"bf{bf}_{i}_{j}"].tobytes(), (bf, i, j)
    assert coords == {(0, 0), (0, 1), (1, 0), (1, 1)}
    # without boundary_frac every rank holds the whole plan's answer; with
    # it, a data shard's interior is its own rows' (these rows are not
    # co-located with their blocks)
    assert len({want[f"bf0_{i}_{j}"].tobytes() for i, j in coords}) == 1
    assert want["bf10_0_0"].tobytes() != want["bf10_1_0"].tobytes()
    assert want["bf10_0_0"].tobytes() == want["bf10_0_1"].tobytes()


if __name__ == "__main__":
    _WORKERS[sys.argv[1]](int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:])

"""The port's FM step builder (``build_fm_step``) against the reference on
the CPU.

* World 1: ``train``, ``serve`` and ``retrieval`` against the reference's
  compiled step on a 1 x 1 mesh (its ``build_fm_step`` lowers there), on
  the SMOKE config with the reference's ``init`` params: loss and gnorm
  within rtol 1e-5, every updated param, moment, logit and score within
  ``TOL * (|ref| + rms(ref))``, ``TOL = 1e-5`` (float32 sums in another
  order), AdamW's bf16 moments within one bf16 step (2**-7 of the larger
  magnitude plus the leaf's rms).
* Worlds 2 (2 x 1: the batch over ``"data"``) and 4 (2 x 2: the table's
  rows over ``"model"`` too) on gloo against world 1, each rank's pieces
  with the same tolerances.

World sizes above 1 run as spawned ranks of this file (``python
tests/test_torch_fm_steps.py <rank> <world> <n_data> <store> <out>``).
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
BATCH, CANDIDATES = 64, 128


def fm_case():
    """(cfg, params, x, y, candidate rows): the SMOKE config, params from
    the port's init on a CPU generator seeded with 0, seeded raw ids."""
    from repro_torch.configs import fm_criteo
    from repro_torch.models import recsys as R

    cfg = fm_criteo.SMOKE
    params = R.init(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(5)
    x = rng.integers(0, 2**31 - 1, (BATCH, cfg.n_fields)).astype(np.int32)
    y = (rng.random(BATCH) < 0.3).astype(np.float32)
    cand = rng.integers(0, cfg.total_rows, CANDIDATES).astype(np.int32)
    return cfg, params, x, y, cand


def fm_record(mesh) -> dict:
    """This rank's pieces of the three steps, by name."""
    from repro_torch.launch import steps
    from repro_torch.tree import flatten_with_paths

    cfg, params, x, y, cand = fm_case()
    rec = {}
    built = steps.build_fm_step(cfg, mesh, "train", dict(batch=BATCH), torch_device="cpu")
    p, o, b = built.shard(params, steps.fm_optimizer().init(params), {"x": x, "y": y})
    new_p, new_o, out = built.fn(p, o, b)
    rec["loss"], rec["gnorm"] = out["loss"].numpy(), out["gnorm"].numpy()
    rec.update({f"param/{k}": v.numpy() for k, v in flatten_with_paths(new_p)})
    rec.update({f"mu/{k}": v.float().numpy() for k, v in flatten_with_paths(new_o.mu)})
    rec["serve"] = steps.build_fm_step(cfg, mesh, "serve", dict(batch=BATCH),
                                       torch_device="cpu").run(params, x).numpy()
    rec["retrieval"] = steps.build_fm_step(
        cfg, mesh, "retrieval", dict(n_candidates=CANDIDATES), torch_device="cpu").run(
        params, x[:1], cand).numpy()
    return rec


def _bf16_close(got, want, what):
    """bf16 moments one rounding step apart at most: within 2**-7 (a step
    of bf16's 8-bit significand) of the larger magnitude plus the leaf's
    rms (a gradient element that is a near cancellation of many float32
    terms, as an embedding row's, carries their rounding, not its own)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    rms = np.sqrt(np.mean(np.square(want))) if want.size else 0.0
    bad = np.abs(got - want) > 2.0 ** -7 * (np.maximum(np.abs(got), np.abs(want)) + rms)
    assert not bad.any(), (what, float(np.abs(got - want).max()))


def _close(got, want, what, tol=TOL):
    want = np.asarray(want, np.float64)
    rms = np.sqrt(np.mean(np.square(want))) if want.size else 0.0
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bad = np.abs(np.asarray(got, np.float64) - want) > tol * (np.abs(want) + rms)
    assert not bad.any(), (what, float(np.abs(got - want).max()), rms)


def compare(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if k in ("loss", "gnorm"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
        else:
            (_bf16_close if k.startswith("mu/") else _close)(got[k], want[k], k)


def _worker(rank, world, n_data, store, out):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=300))
    mesh = make_debug_mesh(n_data, world // n_data, "cpu")
    rec = fm_record(mesh)
    rec["coord"] = np.asarray(mesh.get_coordinate())
    np.savez(f"{out}.{rank}.npz", **rec)


def _spawn(world: int, n_data: int, tmp_path) -> list:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    args = [str(tmp_path / "store"), str(tmp_path / "out")]
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(world), str(n_data), *args],
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


# ---------------------------------------------------------------------- #
#  tests
# ---------------------------------------------------------------------- #
def test_fm_steps_match_reference_compiled_at_1x1():
    jax = pytest.importorskip("jax")

    from repro.configs import fm_criteo as r_fm
    from repro.launch import steps as rsteps

    cfg, params, x, y, cand = fm_case()
    want = fm_record(None)
    rparams = {k: np.asarray(v.numpy()) for k, v in params.items()}
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    ref = {}
    built = rsteps.build_fm_step(r_fm.SMOKE, mesh, "train", dict(batch=BATCH))
    with mesh:
        ropt = rsteps.adamw(rsteps.cosine_schedule(1e-3, 100, 10_000))
        new_p, new_o, out = built.lower(mesh).compile()(rparams, ropt.init(rparams),
                                                         {"x": x, "y": y})
    ref["loss"], ref["gnorm"] = np.asarray(out["loss"]), np.asarray(out["gnorm"])
    ref.update({f"param/{k}": np.asarray(new_p[k]) for k in sorted(new_p)})
    ref.update({f"mu/{k}": np.asarray(new_o.mu[k], np.float32) for k in sorted(new_o.mu)})
    for kind, args, dims in (("serve", (rparams, x), dict(batch=BATCH)),
                             ("retrieval", (rparams, x[:1], cand),
                              dict(n_candidates=CANDIDATES))):
        built = rsteps.build_fm_step(r_fm.SMOKE, mesh, kind, dims)
        with mesh:
            ref[kind] = np.asarray(built.lower(mesh).compile()(*args))
    compare(want, ref)


def test_fm_world1_mesh_step_is_bitwise_the_one_device_step():
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh

    started = not dist.is_initialized()
    try:
        got = fm_record(make_debug_mesh(1, 1, "cpu"))
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
    want = fm_record(None)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("world,n_data", [(2, 2), (4, 2)])
def test_fm_gloo_world_matches_world1(world, n_data, tmp_path):
    """Each gloo rank's pieces of the train, serve and retrieval steps
    against world 1's, cut by the outputs' specs."""
    from test_torch_lm_steps import piece_at

    from repro_torch.distributed.sharding_rules import Spec

    whole = fm_record(None)
    specs = {"loss": Spec(), "gnorm": Spec(), "param/bias": Spec(), "mu/bias": Spec(),
             "param/emb": Spec("model", None), "mu/emb": Spec("model", None),
             "param/w1": Spec("model"), "mu/w1": Spec("model"),
             "serve": Spec("data"), "retrieval": Spec("data")}
    sizes = {"data": n_data, "model": world // n_data}
    coords = set()
    for p in _spawn(world, n_data, tmp_path):
        got = dict(np.load(f"{p}.npz"))
        coord = dict(zip(("data", "model"), (int(c) for c in got.pop("coord"))))
        coords.add(tuple(coord.values()))
        compare(got, {k: piece_at(v, specs[k], sizes, coord) for k, v in whole.items()})
    assert len(coords) == world


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])

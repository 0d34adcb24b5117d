"""Checkpoints, the Trainer and the training driver: port vs reference, on
the CPU.

* Checkpoints: round trip, atomicity and ``keep`` as
  ``tests/test_substrate.py`` holds the reference's; the port reads a
  checkpoint the reference wrote (bitwise, bf16 and int leaves included)
  and the reference reads the port's.
* The Trainer on ``tests/test_substrate.py``'s setup (a linear model on
  TokenStream batches, AdamW, microbatch 2), with and without int8
  compression: the 10 losses within rtol 1e-6 of the reference Trainer's;
  preempt and resume equal to the uninterrupted run (rtol 1e-6), also when
  the port resumes from the reference's checkpoint.
* qwen3-0.6b SMOKE in float32 with ``microbatch=2``, 4 steps, the
  reference's params carried across: the losses within rtol 1e-5.
* Reshard-on-restore: an LM train state (params and AdamW state, the
  layers stacked) written at world 1 restores on two gloo ranks at the
  step builder's FSDP layout (``restore(shardings=)``), each rank's pieces
  bitwise the whole's; written back from there (gathered), it restores at
  world 1 bitwise the original.  The ranks are spawned runs of this file
  (``python tests/test_torch_train.py <rank> <world> <store> <ckpt_dir>``).
"""

import dataclasses
import datetime
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.configs.qwen3_0p6b import SMOKE as R_SMOKE  # noqa: E402
from repro.data.pipeline import TokenStream as RTokenStream  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.optim.optimizers import adamw as r_adamw  # noqa: E402
from repro.optim.schedules import cosine_schedule as r_cosine  # noqa: E402
from repro.train.checkpoints import CheckpointManager as RCheckpointManager  # noqa: E402
from repro.train.trainer import TrainConfig as RTrainConfig  # noqa: E402
from repro.train.trainer import Trainer as RTrainer  # noqa: E402

from repro_torch.configs.qwen3_0p6b import SMOKE  # noqa: E402
from repro_torch.convert import lm_train_params_from_arrays  # noqa: E402
from repro_torch.data.pipeline import TokenStream  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim.optimizers import AdamWState, adamw  # noqa: E402
from repro_torch.optim.schedules import cosine_schedule  # noqa: E402
from repro_torch.train.checkpoints import CheckpointManager  # noqa: E402
from repro_torch.train.fault_tolerance import FaultToleranceMonitor  # noqa: E402
from repro_torch.train.trainer import TrainConfig, Trainer  # noqa: E402


# ----------------------------- checkpoints ---------------------------- #
def test_checkpoint_roundtrip(tmp_path):
    cm = CheckpointManager(tmp_path)
    state = {"a": torch.arange(10, dtype=torch.float32),
             "b": {"c": torch.ones((3, 3)), "h": torch.full((2,), 1.5, dtype=torch.bfloat16)},
             "s": AdamWState(torch.tensor(7, dtype=torch.int32), {"m": torch.zeros(2)},
                             {"m": torch.ones(2)})}
    cm.save(5, state, {"cursor": 42})
    restored, extra, step = cm.restore(state)
    assert step == 5 and extra["cursor"] == 42
    assert isinstance(restored["s"], AdamWState) and int(restored["s"].step) == 7
    assert restored["b"]["h"].dtype == torch.bfloat16
    for a, b in zip(jax.tree_util.tree_leaves(restored), jax.tree_util.tree_leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_atomicity_and_gc(tmp_path):
    cm = CheckpointManager(tmp_path, keep=2)
    state = {"x": torch.zeros(4)}
    for s in (1, 2, 3, 4):
        cm.save(s, state)
    assert cm.steps() == [3, 4]  # old ones garbage-collected
    (tmp_path / "step_9.tmp").mkdir()  # a stale tmp dir is never picked up
    assert cm.latest_step() == 4
    restored, _, step = cm.restore(state, shardings={"x": None})  # no layout: as saved
    assert step == 4 and torch.equal(restored["x"], state["x"])


def _flat_state(rng):
    return {"w": rng.normal(size=(5, 3)).astype(np.float32),
            "moments": {"m": rng.normal(size=(4,)).astype(ml_dtypes.bfloat16),
                        "count": np.arange(6, dtype=np.int32)},
            "z": np.float32(2.5)}


def test_port_reads_the_references_checkpoint_bitwise(tmp_path):
    rng = np.random.default_rng(0)
    state = _flat_state(rng)
    RCheckpointManager(tmp_path).save(3, jax.tree.map(jnp.asarray, state), {"data": {"step": 9}})
    template = {"w": torch.zeros(5, 3), "moments": {"m": torch.zeros(4, dtype=torch.bfloat16),
                                                    "count": torch.zeros(6, dtype=torch.int32)},
                "z": torch.zeros(())}
    got, extra, step = CheckpointManager(tmp_path).restore(template)
    assert step == 3 and extra == {"data": {"step": 9}}
    assert np.array_equal(got["w"].numpy(), state["w"])
    assert got["moments"]["m"].dtype == torch.bfloat16
    assert np.array_equal(got["moments"]["m"].view(torch.int16).numpy().view(np.uint16),
                          state["moments"]["m"].view(np.uint16))
    assert np.array_equal(got["moments"]["count"].numpy(), state["moments"]["count"])
    assert float(got["z"]) == 2.5


def test_reference_reads_the_ports_checkpoint_bitwise(tmp_path):
    rng = np.random.default_rng(1)
    state = _flat_state(rng)
    port = {"w": torch.from_numpy(state["w"]),
            "moments": {"m": torch.from_numpy(state["moments"]["m"].view(np.int16)).view(
                torch.bfloat16), "count": torch.from_numpy(state["moments"]["count"])},
            "z": torch.tensor(state["z"])}
    CheckpointManager(tmp_path).save(4, port, {"k": 1})
    manifest = (tmp_path / "step_4" / "manifest.json").read_text()
    assert '"key": "moments/count"' in manifest and '"dtype": "bfloat16"' in manifest
    got, extra, step = RCheckpointManager(tmp_path).restore(jax.tree.map(jnp.asarray, state))
    assert step == 4 and extra == {"k": 1}
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(state)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


# ------------------------------- trainer ------------------------------- #
def _ref_trainer(path, seed=0, compression=False):
    params = {"w": jnp.asarray(np.random.default_rng(1).normal(size=(16, 8)), jnp.float32)}

    def loss_fn(p, batch):
        x = batch["tokens"].astype(jnp.float32)
        pred = x[:, :8] @ p["w"][:8]
        return jnp.mean(jnp.square(pred - x[:, :8]))

    data = RTokenStream(vocab=50, batch=4, seq=16, seed=seed)
    cfg = RTrainConfig(total_steps=10, microbatch=2, checkpoint_every=5,
                       checkpoint_dir=str(path), grad_compression=compression)
    return RTrainer(loss_fn, r_adamw(1e-2), params, data, cfg)


def _port_trainer(path, seed=0, compression=False):
    params = {"w": torch.from_numpy(
        np.random.default_rng(1).normal(size=(16, 8)).astype(np.float32))}

    def loss_fn(p, batch):
        x = batch["tokens"].float()
        pred = x[:, :8] @ p["w"][:8]
        return torch.mean(torch.square(pred - x[:, :8]))

    data = TokenStream(vocab=50, batch=4, seq=16, seed=seed)
    cfg = TrainConfig(total_steps=10, microbatch=2, checkpoint_every=5,
                      checkpoint_dir=str(path), grad_compression=compression)
    return Trainer(loss_fn, adamw(1e-2), params, data, cfg)


def _losses(tr):
    return [h["loss"] for h in tr.history]


@pytest.mark.parametrize("compression", [False, True])
def test_trainer_losses_match_reference(tmp_path, compression):
    ref = _ref_trainer(tmp_path / "ref", compression=compression)
    ref.run(10)
    port = _port_trainer(tmp_path / "port", compression=compression)
    out = port.run(10)
    assert out["step"] == 10 and len(out["history"]) == 10
    assert set(out["history"][0]) == {"step", "loss", "gnorm", "dt"}
    np.testing.assert_allclose(_losses(port), _losses(ref), rtol=1e-6)
    np.testing.assert_allclose([h["gnorm"] for h in port.history],
                               [h["gnorm"] for h in ref.history], rtol=1e-5)
    np.testing.assert_allclose(port.params["w"].numpy(), np.asarray(ref.params["w"]),
                               rtol=1e-5, atol=1e-6)
    if compression:
        assert port.err_fb is not None
        assert out["history"][-1]["loss"] < out["history"][0]["loss"]


@pytest.mark.parametrize("compression", [False, True])
def test_preempt_resume_identical_trajectory(tmp_path, compression):
    """The fault-tolerance contract: resume == never-crashed."""
    ref = _port_trainer(tmp_path / "ref", compression=compression)
    ref.run(10)
    tr = _port_trainer(tmp_path / "crash", compression=compression)
    tr.run(5)  # checkpoint lands at step 5
    tr.monitor.request_preemption()
    tr.run(100)  # exits immediately (preempted)
    assert tr.step == 5
    tr2 = _port_trainer(tmp_path / "crash", compression=compression)
    assert tr2.resume() == 5 and tr2.step == 5
    assert tr2.data.state() == {"seed": 0, "step": 10}  # two microbatches a step
    tr2.run(5)
    np.testing.assert_allclose(_losses(tr2), _losses(ref)[5:], rtol=1e-6)


def test_port_resumes_from_the_references_checkpoint(tmp_path):
    """Same tree, same leaf order: the reference's step-5 checkpoint
    (params, AdamW state, data cursor) resumes in the port, and the port's
    next 5 losses are the reference's uninterrupted ones."""
    ref = _ref_trainer(tmp_path)
    ref.run(10)  # checkpoints at 5 and 10
    port = _port_trainer(tmp_path)
    ref_losses = _losses(ref)
    state, extra, _ = port.ckpt.restore({"params": port.params, "opt": port.opt_state}, step=5)
    port.params, port.opt_state = state["params"], state["opt"]
    port.data.restore(extra["data"])
    port.step = int(extra["step"])
    assert port.opt_state.mu["w"].dtype == torch.bfloat16 and int(port.opt_state.step) == 5
    port.run(5)
    np.testing.assert_allclose(_losses(port), ref_losses[5:], rtol=1e-6)


def test_straggler_watchdog_and_restart_count(tmp_path):
    tr = _port_trainer(tmp_path)
    tr.run(2)
    assert tr.monitor.events.restarts == 0
    tr.save()
    tr2 = _port_trainer(tmp_path)
    tr2.resume()
    assert tr2.monitor.events.restarts == 1
    mon = FaultToleranceMonitor(straggler_factor=3.0)
    for s in range(20):
        mon.observe_step(s, 0.01)
    mon.observe_step(20, 1.0)
    assert mon.straggler_count() == 1


def test_qwen3_smoke_float32_trains_as_the_reference():
    """4 steps of qwen3-0.6b SMOKE in float32, microbatch 2 (the reference's
    init params carried across): the losses within rtol 1e-5."""
    rcfg = dataclasses.replace(R_SMOKE, compute_dtype="float32")
    pcfg = dataclasses.replace(SMOKE, compute_dtype="float32")
    rparams = RT.init(jax.random.PRNGKey(0), rcfg)
    rtr = RTrainer(lambda p, b: RT.loss_fn(p, b, rcfg), r_adamw(r_cosine(3e-4, 20, 21)),
                   rparams, RTokenStream(vocab=rcfg.vocab, batch=2, seq=32),
                   RTrainConfig(total_steps=4, microbatch=2))
    rtr.run(4)
    pparams = lm_train_params_from_arrays(jax.tree.map(np.asarray, rparams), pcfg,
                                          torch_device="cpu")
    ptr = Trainer(lambda p, b: T.loss_fn(p, b, pcfg), adamw(cosine_schedule(3e-4, 20, 21)),
                  pparams, TokenStream(vocab=pcfg.vocab, batch=2, seq=32),
                  TrainConfig(total_steps=4, microbatch=2))
    ptr.run(4)
    np.testing.assert_allclose(_losses(ptr), _losses(rtr), rtol=1e-5)
    assert _losses(ptr)[-1] < _losses(ptr)[0]


# ----------------------------- the driver ------------------------------ #
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen2-moe-a2.7b", "fm"])
def test_build_trainer_on_cpu_trains_and_resumes(tmp_path, arch):
    kw = dict(smoke=True, batch=2, seq=16, steps=4, ckpt_dir=str(tmp_path / "a"),
              torch_device="cpu")
    tr = launch.build_trainer(arch, **kw)
    assert all(t.dtype == torch.float32 for t in jax.tree_util.tree_leaves(tr.params)
               if isinstance(t, torch.Tensor))
    tr.run(4)  # checkpoints every step (steps // 4)
    losses = _losses(tr)
    assert np.isfinite(losses).all()
    again = launch.build_trainer(arch, **{**kw, "ckpt_dir": str(tmp_path / "a")})
    state, extra, _ = again.ckpt.restore({"params": again.params, "opt": again.opt_state},
                                         step=2)
    again.params, again.opt_state = state["params"], state["opt"]
    again.data.restore(extra["data"])
    again.step = 2
    again.run(2)
    np.testing.assert_allclose(_losses(again), losses[2:], rtol=1e-6)


def test_build_trainer_refuses_gnn_and_a_missing_card():
    with pytest.raises(ValueError, match="GNN"):
        launch.build_trainer("gcn-cora", torch_device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            launch.build_trainer("fm")


def test_main_runs_on_cpu(capsys):
    assert launch.main(["--arch", "fm", "--steps", "2", "--batch", "16", "--device", "cpu"]) == 0
    assert '"steps": 2' in capsys.readouterr().out


# ------------------------- reshard-on-restore -------------------------- #
def _lm_state():
    """qwen3-0.6b SMOKE's float32 params (layers stacked) and AdamW state,
    from the port's init on a CPU generator seeded with 0, one step in."""
    from repro_torch.launch import steps

    params = steps.stack_layers(T.init_master(torch.Generator().manual_seed(0), SMOKE))
    opt = steps._lm_optimizer(SMOKE)
    state = opt.init(params)
    params, state, _ = opt.update(params, state, params)  # the params as a gradient
    return {"params": params, "opt": state}


def _layouts(mesh):
    from repro_torch.distributed.sharding_rules import lm_param_specs, opt_state_specs
    from repro_torch.launch.mesh import dp_axes_of

    state = _lm_state()
    pspec = lm_param_specs(SMOKE, dp_axes_of(mesh))
    specs = {"params": pspec, "opt": opt_state_specs(pspec, state["opt"])}
    from repro_torch.launch.steps import _map_specs2

    return state, _map_specs2(lambda t, sp: (mesh, sp), state, specs)


def _reshard_worker(rank, world, store, ckpt_dir):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.steps import _piece
    from repro_torch.tree import flatten_with_paths, tree_map

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    mesh = make_debug_mesh(world, 1, "cpu")
    whole, layouts = _layouts(mesh)
    cm = CheckpointManager(pathlib.Path(ckpt_dir) / "world1")
    got, _, step = cm.restore(whole, shardings=layouts)
    assert step == 1
    for (key, t), (_, w), (_, lay) in zip(flatten_with_paths(got), flatten_with_paths(whole),
                                          _flat_layouts(whole, layouts)):
        want = _piece(w, lay[1], mesh, torch.device("cpu"))
        local = t.to_local()
        assert local.dtype == want.dtype and torch.equal(local, want), key
    full = tree_map(lambda t: t.full_tensor(), got)
    if rank == 0:
        CheckpointManager(pathlib.Path(ckpt_dir) / "world2").save(2, full, {"from": world})
    dist.barrier()


def _flat_layouts(state, layouts):
    """(path, layout) a leaf of ``state``, in its leaf order."""
    from repro_torch.train.checkpoints import _layouts as leaf_layouts
    from repro_torch.tree import flatten_with_paths

    return [(k, lay) for (k, _), lay in zip(flatten_with_paths(state),
                                            leaf_layouts(state, layouts))]


def test_reshard_on_restore_between_world1_and_world2(tmp_path):
    from repro_torch.tree import flatten_with_paths

    state = _lm_state()
    CheckpointManager(tmp_path / "world1").save(1, state, {"from": 1})
    root = pathlib.Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(root / "src"), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, __file__, str(r), "2", str(tmp_path / "store"),
                               str(tmp_path)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=root) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240))
    finally:
        for p in procs:
            p.kill()
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, o[-2000:] + e[-4000:]
    back, extra, step = CheckpointManager(tmp_path / "world2").restore(state)
    assert step == 2 and extra == {"from": 2}
    for (k, a), (_, b) in zip(flatten_with_paths(back), flatten_with_paths(state)):
        assert a.dtype == b.dtype and torch.equal(a, b), k


if __name__ == "__main__":
    _reshard_worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])

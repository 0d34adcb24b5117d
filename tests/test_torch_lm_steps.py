"""The port's LM step builders (``build_lm_train`` / ``prefill`` /
``decode``) against the reference on the CPU.

* Stand-ins and specs: the argument trees' shapes and dtypes and every
  spec equal the reference's builders' (on a 16 x 16 abstract mesh).
* World 1 (``mesh=None``; a mesh of one device runs the same plain
  tensors): qwen3-0.6b and qwen2-moe-a2.7b SMOKE in float32, params from
  the reference's ``init``, against the reference's unsharded functions
  (its own ``build_lm_*`` cannot lower, R12): ``jax.value_and_grad`` of
  ``loss_fn`` then ``_lm_optimizer(cfg).update`` (AdamW, and Adafactor by
  patching both packages' ``_lm_optimizer``), ``prefill``, ``decode_step``.
  Loss within rtol 1e-5, gnorm 1e-4; each updated param, moment, logit
  and cache element within ``TOL * (|ref| + rms(ref))``, ``TOL = 1e-4``
  (float32 sums in another order; the MoE replays no routing: at these
  sizes no token sits near a tie in float32), AdamW's bf16 moments within
  one bf16 step (2**-7 of the larger magnitude plus the leaf's rms).
* Worlds 2 (1 x 2: TP) and 4 (2 x 2: FSDP x TP) on gloo against world 1,
  each rank holding its own pieces: the same tolerances, in float32; the
  decode step in both of the reference's branches (batch 4, and batch 1
  below the dp shards, the cache's sequence over the whole mesh).
* R12: the reference's LM builders do not lower on jax 0.9.0, even on a
  1 x 1 mesh.

World sizes above 1 run as spawned ranks of this file (``python
tests/test_torch_lm_steps.py <rank> <world> <n_data> <store> <out>``).
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

ROOT = pathlib.Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT_S = 240
TOL = 1e-4
B, S = 4, 32


# ---------------------------------------------------------------------- #
#  cases shared by the test process and the spawned ranks
# ---------------------------------------------------------------------- #
def port_cfg(kind):
    from repro_torch.configs import qwen2_moe_a2p7b, qwen3_0p6b

    mod = {"dense": qwen3_0p6b, "moe": qwen2_moe_a2p7b}[kind]
    return dataclasses.replace(mod.SMOKE, compute_dtype="float32")


def seeded_params(cfg):
    """Float32 master params in the reference's stacked tree, from the
    port's init on a CPU generator seeded with 0."""
    from repro_torch.launch import steps
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T

    mod = M if isinstance(cfg, M.MoEConfig) else T
    return steps.stack_layers(mod.init_master(torch.Generator().manual_seed(0), cfg))


def seeded_batch(cfg, b=B, s=S, seed=3):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}


def padded_cache(cfg, params, tokens, extra=4):
    """The prefill's cache of ``tokens`` with ``extra`` empty positions."""
    from repro_torch.launch import steps

    kv, _ = steps.build_lm_prefill(cfg, None, dict(batch=tokens.shape[0], seq=tokens.shape[1]),
                                   torch_device="cpu").fn(params, torch.from_numpy(tokens))
    return {k: torch.cat([v, v.new_zeros((*v.shape[:3], extra, v.shape[4]))], 3)
            for k, v in kv.items()}


def lm_record(kind, mesh) -> dict:
    """This rank's pieces of one train step, one prefill and the decode
    steps (batch 4; batch 1 for the dense model), by name."""
    from repro_torch.launch import steps
    from repro_torch.tree import flatten_with_paths

    cfg = port_cfg(kind)
    params, batch = seeded_params(cfg), seeded_batch(cfg)
    rec = {}
    built = steps.build_lm_train(cfg, mesh, dict(batch=B, seq=S), torch_device="cpu")
    p, o, b = built.shard(params, steps._lm_optimizer(cfg).init(params), batch)
    new_p, new_o, out = built.fn(p, o, b)
    rec["loss"], rec["gnorm"] = out["loss"].numpy(), out["gnorm"].numpy()
    rec.update({f"param/{k}": v.numpy() for k, v in flatten_with_paths(new_p)})
    rec.update({f"mu/{k}": v.float().numpy() for k, v in flatten_with_paths(new_o.mu)})
    pre = steps.build_lm_prefill(cfg, mesh, dict(batch=B, seq=S), torch_device="cpu")
    kv, logits = pre.fn(*pre.shard(params, batch["tokens"]))
    rec["prefill/logits"], rec["prefill/k"] = logits.numpy(), kv["k"].numpy()
    for bd in ((B, 1) if kind == "dense" else (B,)):
        dec = steps.build_lm_decode(cfg, mesh, dict(batch=bd, seq=S + 4), torch_device="cpu")
        cache = padded_cache(cfg, params, batch["tokens"][:bd])
        logits, kv = dec.fn(*dec.shard(params, batch["tokens"][:bd, 0], cache))
        rec[f"decode{bd}/logits"], rec[f"decode{bd}/v"] = logits.numpy(), kv["v"].numpy()
    return {f"{kind}/{k}": v for k, v in rec.items()}


def out_specs(kind, dp):
    """The spec of every record entry over a mesh with dp axes ``dp``."""
    from repro_torch.launch import steps

    d = steps._dp_spec(dp)
    flat = _flat_specs(steps._lm_param_specs(port_cfg(kind), dp))
    specs = {"loss": steps.Spec(), "gnorm": steps.Spec(),
             "prefill/logits": steps.Spec(d, "model"),
             "prefill/k": steps.Spec(None, d, None, "model", None),
             f"decode{B}/logits": steps.Spec(d, "model"),
             f"decode{B}/v": steps.Spec(None, d, None, "model", None),
             "decode1/logits": steps.Spec(None, "model"),
             "decode1/v": steps.Spec(None, None, None, tuple(dp) + ("model",), None)}
    specs.update({f"param/{k}": sp for k, sp in flat.items()})
    specs.update({f"mu/{k}": sp for k, sp in flat.items()})
    return {f"{kind}/{k}": v for k, v in specs.items()}


def piece_at(x: np.ndarray, spec, sizes: dict, coord: dict) -> np.ndarray:
    """The piece of ``x`` at mesh coordinate ``coord`` (axis -> index) of
    a mesh with axis ``sizes``: each dimension a spec names cut into equal
    contiguous pieces over those axes, the first axis major."""
    from repro_torch.distributed.sharding_rules import entry_axes

    for dim, entry in enumerate(spec):
        count, index = 1, 0
        for a in entry_axes(entry):
            count, index = count * sizes[a], index * sizes[a] + coord[a]
        size = x.shape[dim] // count
        x = np.take(x, np.arange(index * size, (index + 1) * size), axis=dim)
    return x


def _flat_specs(tree, prefix=""):
    from repro_torch.distributed.sharding_rules import Spec

    if isinstance(tree, Spec):
        return {prefix: tree}
    out = {}
    for k in sorted(tree):
        out.update(_flat_specs(tree[k], f"{prefix}/{k}" if prefix else k))
    return out


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
    bad = np.abs(np.asarray(got, np.float64) - want) > tol * (np.abs(want) + rms)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert not bad.any(), (what, float(np.abs(got - want).max()), rms)


def compare(got: dict, want: dict):
    assert got.keys() == want.keys(), sorted(set(got) ^ set(want))
    for k in want:
        if k.endswith("/loss"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
        elif k.endswith("/gnorm"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
        else:  # AdamW's bf16 moments: one bf16 step apart at most
            (_bf16_close if "/mu/" in k else _close)(got[k], want[k], k)


def _worker(rank, world, n_data, store, out):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=300))
    mesh = make_debug_mesh(n_data, world // n_data, "cpu")
    got = {}
    for kind in ("dense", "moe"):
        got.update(lm_record(kind, mesh))
    got["coord"] = np.asarray(mesh.get_coordinate())
    np.savez(f"{out}.{rank}.npz", **got)


def _spawn(world: int, n_data: int, tmp_path) -> list:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    args = [str(tmp_path / f"store_{world}"), str(tmp_path / f"out_{world}")]
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
    return [tmp_path / f"out_{world}.{r}" for r in range(world)]


# ---------------------------------------------------------------------- #
#  tests
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("kind", ["train", "prefill", "decode", "decode_long"])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen2-moe-a2.7b", "grok-1-314b"])
def test_lm_stand_ins_and_specs_match_reference(arch, kind):
    """The argument stand-ins (shapes, dtypes) and the in / out specs equal
    the reference's builders' at the production configs, on a 16 x 16
    abstract mesh (the decode's long branch at batch 1)."""
    jax = pytest.importorskip("jax")
    from jax.sharding import AbstractMesh

    from repro.configs.registry import get_arch as r_arch
    from repro.launch import steps as rsteps
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import steps

    class _Mesh16:
        mesh_dim_names = ("data", "model")

        def size(self, i=None):
            return 16 if i is not None else 256

    amesh = AbstractMesh((16, 16), ("data", "model"))
    dims = {"train": dict(batch=256, seq=64), "prefill": dict(batch=32, seq=64),
            "decode": dict(batch=128, seq=64), "decode_long": dict(batch=1, seq=64)}[kind]
    name = {"train": "build_lm_train", "prefill": "build_lm_prefill",
            "decode": "build_lm_decode", "decode_long": "build_lm_decode"}[kind]
    ref = getattr(rsteps, name)(r_arch(arch).model_cfg, amesh, dims)
    got = getattr(steps, name)(get_arch(arch).model_cfg, _Mesh16(), dims, torch_device="cpu")

    def leaves_of(tree):
        return [x for x in jax.tree_util.tree_leaves(tree)]

    ref_args = leaves_of(ref.args)
    got_args = [t for _, t in _flat_tensors(got.args)]
    assert len(ref_args) == len(got_args)
    for r, g in zip(ref_args, got_args):
        assert tuple(r.shape) == tuple(g.shape), (r.shape, g.shape)
        assert str(r.dtype) == str(g.dtype).replace("torch.", ""), (r.dtype, g.dtype)
    ref_specs = [tuple(s.spec) for s in jax.tree_util.tree_leaves(
        ref.in_shardings, is_leaf=lambda x: hasattr(x, "spec"))]
    got_specs = [tuple(s) for s in _flat_spec_leaves(got.in_specs)]
    assert got_specs == ref_specs
    assert got.donate_argnums == ref.donate_argnums


def _flat_tensors(tree):
    """(path, tensor) in JAX's leaf order (dict keys sorted)."""
    from repro_torch.tree import flatten_with_paths

    return flatten_with_paths(tree)


def _flat_spec_leaves(tree):
    from repro_torch.distributed.sharding_rules import Spec

    if isinstance(tree, Spec):
        return [tree]
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _flat_spec_leaves(tree[k])]
    return [s for t in tree for s in _flat_spec_leaves(t)]


def _ref_cfg(kind):
    from repro.configs import qwen2_moe_a2p7b, qwen3_0p6b

    mod = {"dense": qwen3_0p6b, "moe": qwen2_moe_a2p7b}[kind]
    return dataclasses.replace(mod.SMOKE, compute_dtype="float32")


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_world1_steps_match_reference_unsharded(kind, opt, monkeypatch):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.launch import steps as rsteps
    from repro.models import moe as RM
    from repro.models import transformer as RT
    from repro.optim.optimizers import adafactor as r_adafactor
    from repro.optim.schedules import cosine_schedule as r_cosine
    from repro_torch.launch import steps
    from repro_torch.optim.optimizers import adafactor
    from repro_torch.optim.schedules import cosine_schedule

    if opt == "adafactor":
        monkeypatch.setattr(rsteps, "_lm_optimizer",
                            lambda cfg: r_adafactor(r_cosine(1e-4, 200, 10_000)))
        monkeypatch.setattr(steps, "_lm_optimizer",
                            lambda cfg: adafactor(cosine_schedule(1e-4, 200, 10_000)))
    cfg, rcfg = port_cfg(kind), _ref_cfg(kind)
    rmod = RM if kind == "moe" else RT
    params = seeded_params(cfg)
    rparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
    batch = seeded_batch(cfg)
    rbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    ropt = rsteps._lm_optimizer(rcfg)
    loss, grads = jax.value_and_grad(lambda p: rmod.loss_fn(p, rbatch, rcfg))(rparams)
    want_p, want_o, want_g = ropt.update(grads, ropt.init(rparams), rparams)
    built = steps.build_lm_train(cfg, None, dict(batch=B, seq=S), torch_device="cpu")
    got_p, got_o, out = built.fn(params, steps._lm_optimizer(cfg).init(params),
                                 {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(out["loss"].numpy(), np.asarray(loss), rtol=1e-5)
    np.testing.assert_allclose(out["gnorm"].numpy(), np.asarray(want_g), rtol=1e-4)
    from repro_torch.tree import leaves

    got_leaves = leaves(got_p) + leaves(got_o)
    want_leaves = [np.asarray(x, np.float32) for x in
                   jax.tree_util.tree_leaves(want_p) + jax.tree_util.tree_leaves(want_o)]
    assert len(got_leaves) == len(want_leaves)
    for i, (g, w) in enumerate(zip(got_leaves, want_leaves)):
        # AdamW's bf16 moments: one bf16 step apart at most
        (_bf16_close if g.dtype == torch.bfloat16 else _close)(g.float().numpy(), w,
                                                                f"leaf {i}")

    kv, logits = steps.build_lm_prefill(cfg, None, dict(batch=B, seq=S), torch_device="cpu").fn(
        params, torch.from_numpy(batch["tokens"]))
    rkv, rlogits = rmod.prefill(rparams, rbatch["tokens"], rcfg)
    _close(logits.numpy(), np.asarray(rlogits), "prefill logits")
    _close(kv["k"].numpy(), np.asarray(rkv["k"]), "prefill k")
    cache = padded_cache(cfg, params, batch["tokens"])
    rcache = {k: jnp.asarray(v.numpy().copy()) for k, v in cache.items()}  # the port writes in place
    dec = steps.build_lm_decode(cfg, None, dict(batch=B, seq=S + 4), torch_device="cpu")
    logits, kv = dec.fn(params, torch.from_numpy(batch["tokens"][:, 0]), cache)
    rlogits, rkv = rmod.decode_step(rparams, rbatch["tokens"][:, 0], rcache, S + 3, rcfg)
    _close(logits.numpy(), np.asarray(rlogits), "decode logits")
    _close(kv["v"].numpy(), np.asarray(rkv["v"]), "decode v")


@pytest.fixture(scope="module")
def world1():
    """Both models' records with no mesh (computed once for the file)."""
    rec = {}
    for kind in ("dense", "moe"):
        rec.update(lm_record(kind, None))
    return rec


def test_world1_mesh_step_is_bitwise_the_one_device_step(world1):
    """A 1 x 1 mesh runs plain tensors: the dense model's train, prefill and
    decode steps equal ``mesh=None``'s to the bit."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh

    started = not dist.is_initialized()
    try:
        mesh = make_debug_mesh(1, 1, "cpu")
        got = lm_record("dense", mesh)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
    want = {k: v for k, v in world1.items() if k.startswith("dense/")}
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("world,n_data", [(2, 1), (4, 2)])
def test_gloo_world_matches_world1(world, n_data, tmp_path, world1):
    """Each gloo rank's pieces of the train, prefill and decode steps
    (dense and MoE) against world 1's, cut by the same specs."""
    outs = _spawn(world, n_data, tmp_path)
    sizes = {"data": n_data, "model": world // n_data}
    whole, specs = world1, {}
    for kind in ("dense", "moe"):
        specs.update(out_specs(kind, ("data",)))
    coords = set()
    for p in outs:
        got = dict(np.load(f"{p}.npz"))
        coord = dict(zip(("data", "model"), (int(c) for c in got.pop("coord"))))
        coords.add(tuple(coord.values()))
        compare(got, {k: piece_at(v, specs[k], sizes, coord) for k, v in whole.items()})
    assert len(coords) == world


def test_reference_lm_steps_do_not_lower_r12():
    """R12: the reference's LM step builders raise when lowered, even on a
    1 x 1 mesh: ``actshard.constrain`` hands ``with_sharding_constraint``
    specs over the ``Explicit`` axes ``jax.make_mesh`` creates on jax
    0.9.0.  The port's world-1 steps are held against the reference's
    unsharded functions instead."""
    jax = pytest.importorskip("jax")

    from repro.configs import qwen3_0p6b
    from repro.launch import steps as rsteps

    mesh = jax.make_mesh((1, 1), ("data", "model"))
    for name, dims in (("build_lm_train", dict(batch=2, seq=16)),
                       ("build_lm_prefill", dict(batch=2, seq=16)),
                       ("build_lm_decode", dict(batch=2, seq=16))):
        built = getattr(rsteps, name)(qwen3_0p6b.SMOKE, mesh, dims)
        with pytest.raises(ValueError, match="Auto axes"):
            built.lower(mesh)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])

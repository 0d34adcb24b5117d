"""The port's partition specs (``repro_torch.distributed.sharding_rules``)
against the reference's ``PartitionSpec`` trees, leaf by leaf, for every
registered arch and each optimizer state; and the placements helper on a
one-device CPU mesh."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import registry as r_registry  # noqa: E402
from repro.distributed import sharding_rules as RSR  # noqa: E402
from repro.optim import optimizers as RO  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.distributed import sharding_rules as SR  # noqa: E402
from repro_torch.optim import optimizers as O  # noqa: E402

DP = [("data",), ("pod", "data")]


def canon(tree):
    """A spec tree of either package as plain data: each spec the tuple of
    its entries, each named tuple its type name and fields, dicts by key."""
    if isinstance(tree, (P, SR.Spec)):
        return ("spec", tuple(tuple(e) if isinstance(e, (list, tuple)) else e
                              for e in tree))
    if isinstance(tree, dict):
        return {k: canon(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return (type(tree).__name__,) + tuple(canon(v) for v in tree)
    if isinstance(tree, (list, tuple)):
        return [canon(v) for v in tree]
    return tree


def _family_specs(mod, name, cfg, dp):
    """Every spec tree the family of ``name`` has, from ``mod`` (either
    package's sharding rules) on ``cfg``."""
    fam = r_registry.get_arch(name).family
    out = {"lm_batch": mod.lm_batch_specs(dp), "kv_cache": mod.kv_cache_specs(dp)}
    if fam == "lm-dense":
        for fsdp in (True, False):
            out[f"params_fsdp{fsdp}"] = mod.lm_param_specs(cfg, dp, fsdp)
    elif fam == "lm-moe":
        for fsdp in (True, False):
            for ep in (True, False):
                out[f"params_fsdp{fsdp}_ep{ep}"] = mod.moe_param_specs(
                    cfg, dp, fsdp, expert_parallel=ep)
    elif fam == "gnn":
        out["gnn"] = mod.gnn_specs(dp)
    elif fam == "recsys":
        out["recsys"] = mod.recsys_specs(dp)
    return out


@pytest.mark.parametrize("dp", DP)
@pytest.mark.parametrize("name", r_registry.ARCHS())
def test_spec_trees_match_reference(name, dp):
    assert name in registry.ARCHS()
    ref_cfg = r_registry.get_arch(name).model_cfg
    cfg = registry.get_arch(name).model_cfg
    want = _family_specs(RSR, name, ref_cfg, dp)
    got = _family_specs(SR, name, cfg, dp)
    assert canon(got) == canon(want)


def _opt_states(mod):
    """One state of each optimizer type of ``mod`` (only the type is read)."""
    return {"adamw": mod.AdamWState(None, None, None), "sgd": mod.SGDState(None, None),
            "adafactor": mod.AdafactorState(None, None, None, None)}


@pytest.mark.parametrize("which", ["adamw", "sgd", "adafactor"])
@pytest.mark.parametrize("name", ["qwen3-0.6b", "qwen2-moe-a2.7b", "grok-1-314b", "fm",
                                  "gcn-cora"])
def test_opt_state_specs_match_reference(name, which):
    fam = r_registry.get_arch(name).family
    trees = {}
    for mod, rules, cfg in ((RO, RSR, r_registry.get_arch(name).model_cfg),
                            (O, SR, registry.get_arch(name).model_cfg)):
        if fam == "lm-dense":
            pspec = rules.lm_param_specs(cfg, ("pod", "data"))
        elif fam == "lm-moe":
            pspec = rules.moe_param_specs(cfg, ("data",), expert_parallel=True)
        elif fam == "recsys":
            pspec = {k: v for k, v in rules.recsys_specs().items() if k != "batch"}
        else:  # a GNN's replicated params: a list of matrices
            pspec = {"w": [rules.gnn_specs()["nodes"], rules.gnn_specs()["nodes"]]}
        trees[rules] = rules.opt_state_specs(pspec, _opt_states(mod)[which])
    assert canon(trees[SR]) == canon(trees[RSR])


def test_opt_state_specs_refuse_an_unknown_state():
    with pytest.raises(TypeError):
        SR.opt_state_specs({"w": SR.Spec()}, object())


def test_placements_on_a_mesh():
    """``Shard(i)`` for each mesh dimension a spec names at tensor dim
    ``i``, ``Replicate()`` elsewhere; a DTensor laid out by them holds the
    whole tensor on a one-device mesh."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.mesh import dp_axes_of, make_debug_mesh

    started = not dist.is_initialized()
    try:
        mesh = make_debug_mesh(1, 1, "cpu")
        assert dp_axes_of(mesh) == ("data",)
        assert SR.placements(SR.Spec(None, "data"), mesh) == [Shard(1), Replicate()]
        assert SR.placements(SR.Spec(("data", "model")), mesh) == [Shard(0), Shard(0)]
        assert SR.placements(SR.Spec(), mesh) == [Replicate(), Replicate()]
        with pytest.raises(ValueError):
            SR.placements(SR.Spec(("model", "data")), mesh)
        with pytest.raises(ValueError):
            SR.placements(SR.Spec("pod"), mesh)
        x = torch.arange(12.0).reshape(3, 4)
        dt = distribute_tensor(x, mesh, SR.placements(SR.Spec("model", "data"), mesh))
        assert torch.equal(dt.full_tensor(), x)
        assert np.array_equal(dt.to_local().numpy(), x.numpy())
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def test_map_specs_keeps_structure():
    tree = {"a": [SR.Spec(None, "data"), SR.Spec()],
            "b": O.AdamWState(SR.Spec(), {"w": SR.Spec("model")}, None)}
    out = SR.map_specs(lambda s: len(s), tree)
    assert out == {"a": [2, 0], "b": O.AdamWState(0, {"w": 1}, None)}

"""The port's activation layouts (``repro_torch.distributed.actshard``)
against the reference's on the CPU.

* ``lm_{train,prefill,decode}_acts`` give the reference's specs, one to
  one, single- and multi-pod; with a mesh they add ``moe_shard`` =
  ``(mesh, dp_axes, "model")``.
* ``constrain`` is the identity where the reference's is (``acts`` None,
  the name absent) and on a plain tensor; on a DTensor it redistributes to
  the named spec's placements, values unchanged.
"""

import pytest

torch = pytest.importorskip("torch")


@pytest.mark.parametrize("dp_axes", [("data",), ("pod", "data")])
@pytest.mark.parametrize("which", ["lm_train_acts", "lm_prefill_acts", "lm_decode_acts"])
def test_acts_are_the_reference_specs(which, dp_axes):
    pytest.importorskip("jax")
    from repro.distributed import actshard as ref
    from repro_torch.distributed import actshard

    want = getattr(ref, which)(dp_axes)
    got = getattr(actshard, which)(dp_axes)
    assert got.keys() == want.keys()
    for k in want:
        assert tuple(got[k]) == tuple(want[k]), k
    mesh = object()
    with_mesh = getattr(actshard, which)(dp_axes, mesh)
    assert with_mesh["moe_shard"] == (mesh, tuple(dp_axes), "model")
    assert getattr(ref, which)(dp_axes, mesh)["moe_shard"][1:] == with_mesh["moe_shard"][1:]


def test_constrain_is_the_identity_where_the_reference_is():
    from repro_torch.distributed.actshard import constrain, lm_train_acts

    x = torch.arange(24.0).reshape(2, 3, 4)
    acts = lm_train_acts(("data",))
    assert constrain(x, None, "res") is x
    assert constrain(x, acts, "absent") is x
    assert constrain(x, acts, "res") is x  # a plain tensor: one device


def test_constrain_redistributes_a_dtensor():
    """Over a 1 x 1 mesh (a world of one in this process) a DTensor lands
    at the spec's placements, its values unchanged."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.distributed.actshard import constrain, lm_prefill_acts, lm_train_acts
    from repro_torch.launch.mesh import make_debug_mesh

    started = not dist.is_initialized()
    try:
        mesh = make_debug_mesh(1, 1, "cpu")
        x = torch.arange(24.0).reshape(2, 3, 4)
        xd = DTensor.from_local(x, mesh, [Replicate(), Replicate()])
        res = constrain(xd, lm_train_acts(("data",), mesh), "res")
        assert list(res.placements) == [Shard(0), Shard(1)]
        assert torch.equal(res.full_tensor(), x)
        logits = constrain(DTensor.from_local(x[:, 0], mesh, [Replicate(), Replicate()]),
                           lm_prefill_acts(("data",)), "logits")
        assert list(logits.placements) == [Shard(0), Shard(1)]
        assert torch.equal(logits.full_tensor(), x[:, 0])
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()

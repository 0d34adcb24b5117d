"""Kernel K1 (segment sum), port vs reference, on the CPU.

The port's ``segment_sum`` (its plain version here: the tensors lie on the
CPU) against the reference's Pallas ``segment_sum`` in interpret mode, over
the reference kernel sweep's shapes.  Tolerance: rtol = atol = 1e-5 on
normal values, because the port sums each segment in row order and the
reference kernel through a one-hot matmul — another order of the same
float32 adds.  Integer-valued inputs (every partial sum exact in float32)
are compared bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.segment_reduce import ops as r_ops  # noqa: E402
from repro.kernels.segment_reduce.ref import segment_reduce_ref as r_seg_ref  # noqa: E402

from repro_torch.kernels.segment_reduce import ops as p_ops  # noqa: E402
from repro_torch.kernels.segment_reduce.ref import segment_reduce_ref  # noqa: E402
from repro_torch.kernels.segment_reduce.segment_reduce import (  # noqa: E402
    segment_sum_tiled,
)


def _case(n, m, s, d, integer, seed):
    rng = np.random.default_rng(seed)
    if integer:
        vals = rng.integers(0, 100, size=(n, d)).astype(np.float32)
    else:
        vals = rng.normal(size=(n, d)).astype(np.float32)
    seg = np.sort(rng.integers(0, s, m)).astype(np.int32)
    gidx = rng.integers(0, n, m).astype(np.int32)
    return vals, seg, gidx


@pytest.mark.parametrize("integer", [False, True])
@pytest.mark.parametrize(
    "n,m,s,d",
    [
        (50, 200, 17, 1),
        (100, 1000, 100, 4),
        (1000, 5000, 600, 8),  # multiple output tiles
        (300, 700, 513, 3),  # segments straddle the TS=512 boundary
        (64, 0, 10, 4),  # empty input
        (128, 512, 1, 2),  # single segment
        (2000, 3000, 1200, 130),  # D > 128 lanes
    ],
)
def test_segment_sum_matches_reference(n, m, s, d, integer):
    vals, seg, gidx = _case(n, m, s, d, integer, seed=n + m + d)
    rplan = r_ops.build_tile_plan(gidx, seg, s)
    ref = np.asarray(r_ops.segment_sum(rplan, jnp.asarray(vals)))
    pplan = p_ops.build_tile_plan(gidx, seg, s, torch_device="cpu")
    got = p_ops.segment_sum(pplan, torch.from_numpy(vals)).numpy()
    assert got.shape == ref.shape == (s, d) and got.dtype == np.float32
    if integer:
        assert np.array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    # the pre-gathered form is the same function
    gathered = torch.from_numpy(vals)[pplan.gather_padded.long()]
    assert np.array_equal(p_ops.segment_sum_gathered(pplan, gathered).numpy(), got)


def test_empty_segments_are_identity():
    seg = np.array([0, 0, 1, 2, 10, 10], np.int32)
    gidx = np.arange(6, dtype=np.int32)
    vals = torch.arange(1, 7, dtype=torch.float32)
    plan = p_ops.build_tile_plan(gidx, seg, 12, torch_device="cpu")
    out = p_ops.segment_sum(plan, vals).numpy()
    assert np.array_equal(out, [3, 3, 4, 0, 0, 0, 0, 0, 0, 0, 11, 0])


@pytest.mark.parametrize("op", ["min", "max"])
def test_minmax_reduce_matches_reference(op):
    vals, seg, gidx = _case(200, 900, 70, 3, integer=False, seed=5)
    got = p_ops.segment_reduce(torch.from_numpy(vals), gidx, seg, 70, op).numpy()
    ref = np.asarray(r_seg_ref(jnp.asarray(vals), jnp.asarray(gidx),
                               jnp.asarray(seg), 70, op))
    assert np.array_equal(got, ref)  # min/max are exact in any order
    assert np.isinf(got[np.bincount(seg, minlength=70) == 0]).all()


def test_sum_oracle_agrees_with_plan_path():
    vals, seg, gidx = _case(300, 2000, 90, 2, integer=True, seed=9)
    v = torch.from_numpy(vals)
    ref = segment_reduce_ref(v, torch.from_numpy(gidx), torch.from_numpy(seg), 90)
    assert torch.equal(p_ops.segment_reduce(v, gidx, seg, 90, "add"), ref)


def test_wrapper_refuses_other_devices_and_bad_inputs():
    plan = p_ops.build_tile_plan(np.zeros(3, np.int32), np.zeros(3, np.int32), 1,
                                 torch_device="cpu")
    meta = torch.empty((4, 1), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError):  # plan tensors on another device
        segment_sum_tiled(meta, None, plan.seg_tiles, plan.m2out,
                          num_out_tiles=1, tm=plan.tm, ts=plan.ts)
    with pytest.raises(TypeError):  # the kernel takes float32 only
        segment_sum_tiled(torch.zeros((4, 1), dtype=torch.float64),
                          plan.gather_padded, plan.seg_tiles, plan.m2out,
                          num_out_tiles=1, tm=plan.tm, ts=plan.ts)


def test_failed_build_raises(monkeypatch, tmp_path):
    from repro_torch.kernels import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="build failed"):
        build.build(("segment_sum",))
    assert not any(tmp_path.glob("*.so"))

"""Kernel K1 (segment reduce: sum, min, max), port vs reference, on the CPU.

The port's ``segment_sum`` and ``segment_reduce_multi`` (their plain version
here: the tensors lie on the CPU) against the reference's Pallas
``segment_sum`` in interpret mode, over the reference kernel sweep's shapes,
and, for min/max columns, against the reference executor's masked
``_segment_minmax_gathered`` over the reference's plan of the same rows.
Tolerance: rtol = atol = 1e-5 on normal values' sums, because the port sums
each segment in another order than the reference kernel's one-hot matmul.
Integer-valued inputs (every partial sum exact in float32) are compared bit
for bit, and min/max bit for bit on any values (NaN where NaN).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import engine_jax as r_engine  # noqa: E402
from repro.kernels.segment_reduce import ops as r_ops  # noqa: E402
from repro.kernels.segment_reduce.ref import segment_reduce_ref as r_seg_ref  # noqa: E402

from repro_torch.kernels.segment_reduce import ops as p_ops  # noqa: E402
from repro_torch.kernels.segment_reduce.ref import segment_reduce_ref  # noqa: E402
from repro_torch.kernels.segment_reduce.segment_reduce import (  # noqa: E402
    segment_reduce_tiled,
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


def _plan_rows(kind, rng):
    """(gather, sorted segment ids, segments, headroom) of one plan case."""
    if kind == "long_run":  # one segment of 3,000 rows: several tiles long
        seg = np.concatenate([np.full(3000, 5), np.sort(rng.integers(6, 900, 2000))])
        return rng.integers(0, 1000, seg.size), seg, 900, 0.0
    if kind == "empty":  # most segments and most output tiles empty
        return rng.integers(0, 1000, 300), np.sort(rng.integers(0, 5000, 300)), 5000, 0.0
    # all-pad tiles in every group ("headroom") or none ("plain")
    return (rng.integers(0, 1000, 5000), np.sort(rng.integers(0, 600, 5000)), 600,
            1.0 if kind == "headroom" else 0.0)


def _reference_reduce(rplan, vals, monoids, s):
    """The reference's answer column group by column group: its Pallas
    ``segment_sum`` for the sums, its executor's masked segment min/max
    over the plan-layout gather for the rest."""
    n_sum, n_min, _ = monoids
    parts = []
    if n_sum:
        parts.append(np.asarray(r_ops.segment_sum(rplan, jnp.asarray(vals[:, :n_sum]))))
    gathered = jnp.take(jnp.asarray(vals), rplan.gather_padded, axis=0)
    for op, cols in (("min", slice(n_sum, n_sum + n_min)),
                     ("max", slice(n_sum + n_min, vals.shape[1]))):
        if cols.stop > cols.start:
            parts.append(np.asarray(r_engine._segment_minmax_gathered(
                rplan, gathered[:, cols], s, op)))
    return np.concatenate(parts, axis=1)


@pytest.mark.parametrize("kind", ["plain", "headroom", "empty", "long_run"])
@pytest.mark.parametrize("monoids", [(0, 1, 0), (1, 1, 1), (2, 1, 1)])
def test_segment_reduce_matches_reference(kind, monoids):
    _check_segment_reduce(kind, monoids)


def test_segment_reduce_wide_matches_reference():
    _check_segment_reduce("headroom", (64, 33, 33))  # C = 130


def _check_segment_reduce(kind, monoids):
    rng = np.random.default_rng(sum(monoids) + len(kind))
    gidx, seg, s, headroom = _plan_rows(kind, rng)
    gidx = gidx.astype(np.int32)
    rplan = r_ops.build_tile_plan(gidx, seg, s, headroom=headroom)
    pplan = p_ops.build_tile_plan(gidx, seg, s, headroom=headroom, torch_device="cpu")
    for f in ("gather_padded", "seg_tiles", "m2out"):
        assert np.array_equal(getattr(pplan, f).numpy(), np.asarray(getattr(rplan, f)))
    if kind == "headroom":
        assert (pplan.seg_tiles[:, 0] < 0).any()  # the plan has all-pad tiles
    c, n_sum = sum(monoids), monoids[0]
    for vals in (rng.integers(0, 100, (1000, c)).astype(np.float32),
                 rng.normal(size=(1000, c)).astype(np.float32)):
        got = p_ops.segment_reduce_multi(pplan, torch.from_numpy(vals), monoids).numpy()
        ref = _reference_reduce(rplan, vals, monoids, s)
        assert got.shape == ref.shape == (s, c) and got.dtype == np.float32
        assert np.array_equal(got[:, n_sum:], ref[:, n_sum:])  # min/max: exact
        if vals[0, 0] == np.round(vals[0, 0]):
            assert np.array_equal(got, ref)
        else:
            np.testing.assert_allclose(got[:, :n_sum], ref[:, :n_sum], rtol=1e-5, atol=1e-5)
        ident = np.array([0.0] * n_sum + [np.inf] * monoids[1] + [-np.inf] * monoids[2],
                         np.float32)
        empty = np.bincount(seg, minlength=s) == 0
        assert np.array_equal(got[empty], np.broadcast_to(ident, (int(empty.sum()), c)))


@pytest.mark.parametrize("kind", ["headroom", "long_run"])
def test_segment_reduce_keeps_nan_like_reference(kind):
    rng = np.random.default_rng(11)
    gidx, seg, s, headroom = _plan_rows(kind, rng)
    gidx = gidx.astype(np.int32)
    vals = rng.integers(0, 100, (1000, 4)).astype(np.float32)
    # NaN in the min/max columns only: the reference's one-hot matmul sum
    # spreads a NaN over its whole output tile (0 * NaN = NaN)
    vals[rng.integers(0, 1000, 30), rng.integers(2, 4, 30)] = np.nan
    rplan = r_ops.build_tile_plan(gidx, seg, s, headroom=headroom)
    pplan = p_ops.build_tile_plan(gidx, seg, s, headroom=headroom, torch_device="cpu")
    got = p_ops.segment_reduce_multi(pplan, torch.from_numpy(vals), (2, 1, 1)).numpy()
    ref = _reference_reduce(rplan, vals, (2, 1, 1), s)
    assert np.isnan(ref[:, 2:]).any() and not np.isnan(ref[:, 2:]).all()
    assert np.array_equal(got, ref, equal_nan=True)


@pytest.mark.parametrize("monoids", [(2, 0, 0), (1, 1, 2), (-1, 2, 2), (1, 2)])
def test_wrapper_refuses_monoids_that_do_not_split_the_columns(monoids):
    plan = p_ops.build_tile_plan(np.zeros(3, np.int32), np.zeros(3, np.int32), 1,
                                 torch_device="cpu")
    with pytest.raises(ValueError, match="monoids"):
        segment_reduce_tiled(torch.zeros((4, 3)), plan.gather_padded, plan.seg_tiles,
                             plan.m2out, monoids=monoids, num_out_tiles=1,
                             tm=plan.tm, ts=plan.ts)


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

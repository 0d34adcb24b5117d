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

The wide route's work split (slices of plan rows x 128-column tiles, cut
runs' partials combined in slice order) is checked through its NumPy model
(``_k1_wide_model``), which the card's tests hold the kernel to bit for bit:
bitwise the reference on integer data, within 1e-5 of the plain version on
normal data, every output cell written exactly once.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import engine_jax as r_engine  # noqa: E402
from repro.kernels.segment_reduce import ops as r_ops  # noqa: E402
from repro.kernels.segment_reduce.ref import segment_reduce_ref as r_seg_ref  # noqa: E402

from _k1_wide_model import wide_model  # noqa: E402
from repro_torch.kernels.segment_reduce import ops as p_ops  # noqa: E402
from repro_torch.kernels.segment_reduce import segment_reduce as p_seg  # noqa: E402
from repro_torch.kernels.segment_reduce.ref import segment_reduce_ref  # noqa: E402
from repro_torch.kernels.segment_reduce.segment_reduce import (  # noqa: E402
    segment_reduce_plain,
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


def _wide_case(kind, monoids, slice_rows):
    """The wide route's model on one plan case, integer then normal values:
    ``[(segments, rows, slice_rows, model, writes, plain, mass, ref)]``
    (``mass``: each segment's sum of |terms|; ``ref``: the reference's
    answer, integer values only)."""
    rng = np.random.default_rng(sum(monoids) + len(kind))
    gidx, seg, s, headroom = _plan_rows(kind, rng)
    gidx = gidx.astype(np.int32)
    rplan = r_ops.build_tile_plan(gidx, seg, s, headroom=headroom)
    pplan = p_ops.build_tile_plan(gidx, seg, s, headroom=headroom, torch_device="cpu")
    rows = pplan.seg_tiles.numel()
    slice_rows = slice_rows or p_seg.wide_slice_rows(rows)
    c = sum(monoids)
    kw = dict(num_out_tiles=pplan.num_out_tiles, ts=pplan.ts)
    out = []
    for integer in (True, False):
        vals = (rng.integers(0, 100, (1000, c)) if integer
                else rng.normal(size=(1000, c))).astype(np.float32)
        model, writes = wide_model(vals, pplan.gather_padded.numpy(), pplan.seg_tiles.numpy(),
                                   pplan.m2out.numpy(), monoids, pplan.num_out_tiles,
                                   pplan.tm, pplan.ts, slice_rows)
        v = torch.from_numpy(vals)
        plain = segment_reduce_plain(v, pplan.gather_padded, pplan.seg_tiles,
                                     monoids=monoids, **kw).numpy()[:s]
        mass = segment_reduce_plain(v.abs(), pplan.gather_padded, pplan.seg_tiles,
                                    monoids=(c, 0, 0), **kw).numpy()[:s]
        ref = _reference_reduce(rplan, vals, monoids, s) if integer else None
        out.append((s, rows, slice_rows, model, writes, plain, mass, ref))
    return out


@pytest.mark.parametrize("kind,monoids,slice_rows", [
    ("plain", (33, 0, 0), None), ("headroom", (33, 0, 0), None),
    ("empty", (33, 0, 0), None), ("long_run", (33, 0, 0), None),
    ("plain", (64, 33, 33), None), ("headroom", (64, 33, 33), None),
    ("empty", (64, 33, 33), None), ("long_run", (64, 33, 33), None),
    ("long_run", (64, 33, 33), 128), ("headroom", (64, 33, 33), 1024),
    ("plain", (64, 33, 33), 1024), ("empty", (33, 0, 0), 1024),
    ("long_run", (1433, 0, 0), None), ("empty", (1433, 0, 0), None),
])
def test_wide_route_model_matches_reference(kind, monoids, slice_rows):
    """Integer values bitwise the reference; normal values' sums within 1e-5
    of each segment's sum of |terms| from the plain version (the two add in
    other orders), min/max bitwise."""
    n_sum = monoids[0]
    for s, rows, slice_rows, model, writes, plain, mass, ref in _wide_case(kind, monoids,
                                                                           slice_rows):
        # every output cell written exactly once, by a run, a gap or a group fill
        assert (writes == 1).all()
        if kind == "long_run":  # the 3,000-row run crosses many slices
            assert 3000 // slice_rows >= 2
        if ref is not None:  # integer values: every partial sum exact
            assert np.array_equal(model[:s], ref)
        else:
            assert (np.abs(model[:s, :n_sum] - plain[:, :n_sum])
                    <= 1e-5 * mass[:, :n_sum]).all()
            assert np.array_equal(model[:s, n_sum:], plain[:, n_sum:])


def test_wide_route_model_keeps_nan():
    rng = np.random.default_rng(12)
    gidx, seg, s, headroom = _plan_rows("long_run", rng)
    pplan = p_ops.build_tile_plan(gidx.astype(np.int32), seg, s, torch_device="cpu")
    vals = rng.integers(0, 100, (1000, 40)).astype(np.float32)
    vals[rng.integers(0, 1000, 30), rng.integers(20, 40, 30)] = np.nan
    monoids = (20, 10, 10)
    model, writes = wide_model(vals, pplan.gather_padded.numpy(), pplan.seg_tiles.numpy(),
                               pplan.m2out.numpy(), monoids, pplan.num_out_tiles, pplan.tm,
                               pplan.ts, 32)
    plain = segment_reduce_plain(torch.from_numpy(vals), pplan.gather_padded, pplan.seg_tiles,
                                 monoids=monoids, num_out_tiles=pplan.num_out_tiles,
                                 ts=pplan.ts).numpy()[:s]
    assert np.isnan(plain[:, 20:]).any() and (writes == 1).all()
    assert np.array_equal(model[:s], plain, equal_nan=True)


def test_route_table():
    assert [p_seg.route(c) for c in (1, 2, 3, 4, 24, 32)] == ["narrow"] * 6
    assert [p_seg.route(c) for c in (33, 64, 100, 128, 1433)] == ["wide"] * 5
    assert p_seg.route(p_seg.NARROW_MAX_C) == "narrow"
    assert p_seg.route(p_seg.NARROW_MAX_C + 1) == "wide"
    prev = 0
    for rows in (512, 11_264, 169_984, 1 << 21, 62_000_000, 1 << 31):
        n = p_seg.wide_slice_rows(rows)
        assert n & (n - 1) == 0 and n % 4 == 0
        assert p_seg.WIDE_SLICE_MIN <= n <= p_seg.WIDE_SLICE_MAX and n >= prev
        assert n == p_seg.WIDE_SLICE_MAX or -(-rows // n) <= p_seg.WIDE_SLICES
        prev = n


def test_wrapper_limits_by_route(monkeypatch):
    """The narrow route's shared-memory limit binds only where the table
    sends C to it (here with its threshold raised); the wide route takes
    the same C.  Fake tensors take the kernel's route without a card."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    plan = p_ops.build_tile_plan(np.zeros(3, np.int32), np.zeros(3, np.int32), 1,
                                 torch_device="cpu")
    wide_c = p_seg.NARROW_SMEM_BYTES // 16 + 1  # past the narrow route's carry
    before = dict(segment_sum_tiled.launches_by_route)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        args = [mode.from_tensor(t) for t in (plan.gather_padded, plan.seg_tiles,
                                              plan.m2out)]
        values = torch.empty((4, wide_c))
        kw = dict(monoids=(wide_c, 0, 0), num_out_tiles=1, tm=plan.tm, ts=plan.ts)
        out = segment_reduce_tiled(values, *args, **kw)  # the table's: wide
        assert tuple(out.shape) == (plan.ts, wide_c)
        monkeypatch.setattr(p_seg, "NARROW_MAX_C", wide_c)
        with pytest.raises(ValueError, match="narrow route"):
            segment_reduce_tiled(values, *args, **kw)
    assert segment_sum_tiled.launches_by_route == before  # a fake launch counts nothing


def test_failed_build_raises(monkeypatch, tmp_path):
    from repro_torch.kernels import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="build failed"):
        build.build(("segment_sum",))
    assert not any(tmp_path.glob("*.so"))

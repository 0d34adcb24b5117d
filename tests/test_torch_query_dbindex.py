"""``query_dbindex`` over ``[n, D]`` features, port vs reference, on the CPU.

The reference's one-aggregate query takes ``values`` as ``[n]`` or ``[n,
D]`` (``src/repro/core/engine_jax.py:327-348``): sum, min and max return
``[n, D]``, count ``[n]``, and avg fails on its ``[n, D] / [n]``
broadcast.  The port follows it, with every column on K1's columns of the
same two passes.  Integer-valued features make every float32 partial
exact, so the comparisons are bitwise; the per-column check also runs on
normal floats, where it still holds bit for bit because K1's order of
adds does not depend on the other columns.  ``query_dbindex_multi`` keeps
its ``[B, n]`` batch meaning.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import engine_jax as ej  # noqa: E402
from repro.core.dbindex import build_dbindex as r_build  # noqa: E402
from repro.core.windows import KHopWindow as RKHop  # noqa: E402
from repro.graphs.generators import erdos_renyi as r_er  # noqa: E402

from repro_torch.core import engine_torch as et  # noqa: E402
from repro_torch.core.dbindex import build_dbindex  # noqa: E402
from repro_torch.core.windows import KHopWindow  # noqa: E402
from repro_torch.graphs.generators import erdos_renyi  # noqa: E402
from repro_torch.kernels.segment_reduce.segment_reduce import segment_sum_tiled  # noqa: E402

N, D = 300, 5


@pytest.fixture(scope="module", params=["ell", "no_ell"])
def plans(request):
    """The reference's and the port's plans of one ER n = 300 graph,
    ``KHop(1)``; ``no_ell`` drops the ELL layouts, so min and max ride K1's
    columns too."""
    import dataclasses

    g = erdos_renyi(N, 3.0, directed=False, seed=7)
    rg = r_er(N, 3.0, directed=False, seed=7)
    assert np.array_equal(g.src, rg.src) and np.array_equal(g.dst, rg.dst)
    rplan = ej.plan_from_dbindex(r_build(rg, RKHop(1), method="emc"), tm=64, ts=64)
    plan = et.plan_from_dbindex(build_dbindex(g, KHopWindow(1), method="emc"),
                                tm=64, ts=64, torch_device="cpu")
    if request.param == "no_ell":
        rplan = dataclasses.replace(rplan, p1_ell=None, p2_ell=None)
        plan = dataclasses.replace(plan, p1_ell=None, p2_ell=None)
    return plan, rplan


def _features(seed, integer=True):
    rng = np.random.default_rng(seed)
    if integer:
        return rng.integers(0, 100, (N, D)).astype(np.float64)
    return rng.standard_normal((N, D)).astype(np.float32)


@pytest.mark.parametrize("agg", ["sum", "min", "max", "count"])
def test_features_match_reference_shape_and_values(plans, agg):
    plan, rplan = plans
    x = _features(11)
    got = et.query_dbindex(plan, x, agg).numpy()
    if rplan.p1_ell is None and agg in ("min", "max"):
        # the reference misreads [n, D] here (R10, the test below): its
        # answer is its own one-column queries side by side
        want = np.stack([np.asarray(ej.query_dbindex(rplan, x[:, j], agg,
                                                     use_pallas=False))
                         for j in range(D)], axis=1)
    else:
        want = np.asarray(ej.query_dbindex(rplan, x, agg, use_pallas=False))
    assert got.shape == want.shape == ((N,) if agg == "count" else (N, D))
    assert got.dtype == want.dtype and np.array_equal(got, want), agg


@pytest.mark.parametrize("agg", ["min", "max"])
def test_minmax_features_without_ell_unlike_the_reference(plans, agg):
    """R10: without ELL layouts the reference's min/max gathers with
    ``jnp.take(values, gather_padded)`` and no axis
    (``src/repro/core/engine_jax.py:370,378``), so ``[n, D]`` features are
    read flattened and come back ``[n]``.  The port returns ``[n, D]``, each
    column bitwise the reference's own ``[n]`` query of that column."""
    plan, rplan = plans
    x = _features(11)
    got = et.query_dbindex(plan, x, agg).numpy()
    assert got.shape == (N, D)
    for j in range(D):
        col = np.asarray(ej.query_dbindex(rplan, x[:, j], agg, use_pallas=False))
        assert np.array_equal(got[:, j], col), (agg, j)
    if rplan.p1_ell is None:
        wrong = np.asarray(ej.query_dbindex(rplan, x, agg, use_pallas=False))
        assert wrong.shape == (N,)


def test_avg_over_features_raises_as_the_reference_does(plans):
    plan, rplan = plans
    x = _features(12)
    with pytest.raises(Exception):
        ej.query_dbindex(rplan, x, "avg", use_pallas=False)
    with pytest.raises(ValueError):
        et.query_dbindex(plan, x, "avg")


@pytest.mark.parametrize("integer", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("agg", ["sum", "min", "max"])
def test_each_column_is_bitwise_the_one_column_query(plans, agg, integer):
    plan, _ = plans
    x = _features(13, integer)
    got = et.query_dbindex(plan, x, agg).numpy()
    for j in range(D):
        col = et.query_dbindex(plan, x[:, j], agg).numpy()
        assert got[:, j].tobytes() == col.tobytes(), (agg, j)


def test_features_take_two_k1_launches_on_the_columns(plans, monkeypatch):
    """Sum over ``[n, D]`` is one K1 call a pass, ``D`` columns wide."""
    from repro_torch.core import engine_torch

    plan, _ = plans
    calls = []
    real = engine_torch.segment_reduce_multi

    def counted(tp, values, monoids):
        calls.append((values.shape[1], tuple(monoids)))
        return real(tp, values, monoids)

    monkeypatch.setattr(engine_torch, "segment_reduce_multi", counted)
    before = segment_sum_tiled.launches
    et.query_dbindex(plan, _features(14), "sum")
    assert calls == [(D, (D, 0, 0)), (D, (D, 0, 0))]
    assert segment_sum_tiled.launches == before  # CPU tensors: the plain version


def test_multi_keeps_its_batch_meaning(plans):
    """``query_dbindex_multi`` reads a 2-D input as a ``[B, n]`` batch of
    attribute vectors, as ``run_many`` and the service rely on."""
    plan, _ = plans
    vb = _features(15).T.copy()  # [D, n]
    (got,) = et.query_dbindex_multi(plan, vb, ("sum",))
    assert tuple(got.shape) == (D, N)
    feats = et.query_dbindex(plan, vb.T, "sum").numpy()
    assert np.array_equal(got.numpy(), feats.T)


def test_features_of_the_wrong_height_raise(plans):
    plan, _ = plans
    with pytest.raises(ValueError):
        et.query_dbindex(plan, np.zeros((N + 1, D)), "sum")

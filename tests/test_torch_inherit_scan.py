"""The inheritance scan's plain versions (level and doubling schedules)
against the reference's ``_inherit_scan``, on the CPU.

Both schedules combine each vertex with exactly the values the reference
combines it with, in the same order, so the results agree bit for bit on
any float32 data given the same partials — normal values, NaN in the
min/max columns, and the -0.0 that the doubling schedule's combine with
the identity turns into +0.0.  The forests are made with numpy from a
seed and handed to both packages as arrays.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.core import engine_jax as ej  # noqa: E402

from repro_torch.kernels.inherit_scan import inherit_scan as k  # noqa: E402
from repro_torch.kernels.inherit_scan.ops import inherit, level_layout  # noqa: E402

MONOIDS = ("sum", "min", "max")


def forest(kind: str, n: int, seed: int):
    """(pid, level) of a PID forest: ``pid[v]`` precedes ``v`` in a random
    topological order, and the ids are relabelled at random."""
    rng = np.random.default_rng(seed)
    if kind == "chain":  # one path: depth n - 1
        parent = np.arange(-1, n - 1)
    elif kind == "star":  # one root, every other vertex at level 1
        parent = np.zeros(n, np.int64)
        parent[0] = -1
    else:  # random parents among the earlier vertices, ~5 % roots
        parent = (rng.random(n) * np.arange(n)).astype(np.int64)
        parent[(rng.random(n) < 0.05) | (np.arange(n) == 0)] = -1
    level = np.zeros(n, np.int64)
    for v in range(n):
        if parent[v] >= 0:
            level[v] = level[parent[v]] + 1
    perm = rng.permutation(n)  # old id -> new id
    pid = np.full(n, -1, np.int32)
    has = parent >= 0
    pid[perm[has]] = perm[parent[has]]
    lv = np.empty(n, np.int32)
    lv[perm] = level
    return pid, lv


def values(kind: str, n: int, c: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "int":
        return rng.integers(0, 100, (n, c)).astype(np.float32)
    x = rng.normal(size=(n, c)).astype(np.float32)
    if kind == "nan":
        x[rng.integers(0, n, max(1, n // 20)), rng.integers(0, c, max(1, n // 20))] = np.nan
    if kind == "negzero":
        x[rng.random((n, c)) < 0.3] = -0.0
    return x


def reference(wdp, pid, level, monoids, schedule):
    """The reference's ``_inherit_scan``, one call per monoid group."""
    n = wdp.shape[0]
    max_level = int(level.max()) if n else 0
    outs, lo = [], 0
    for name, cnt in zip(MONOIDS, monoids):
        if cnt:
            outs.append(np.asarray(ej._inherit_scan(
                jnp.asarray(wdp[:, lo:lo + cnt]), jnp.asarray(pid), jnp.asarray(level),
                max_level, n, name, schedule)))
        lo += cnt
    return np.concatenate(outs, axis=1)


def port(wdp, pid, level, monoids, schedule):
    order, level_ptr = level_layout(level)
    return inherit(torch.from_numpy(wdp), torch.from_numpy(pid), torch.from_numpy(order),
                   torch.from_numpy(level_ptr), int(level.max()), monoids, schedule).numpy()


def assert_bitwise(got, want):
    """Same NaN positions, and the same bits everywhere else (so +0.0 and
    -0.0 differ)."""
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    assert np.array_equal(got.view(np.uint32)[~nan], want.view(np.uint32)[~nan])


@pytest.mark.parametrize("schedule", ["level", "doubling"])
@pytest.mark.parametrize("data", ["int", "normal", "nan", "negzero"])
@pytest.mark.parametrize("kind,n", [("random", 400), ("chain", 130), ("star", 300)])
@pytest.mark.parametrize("monoids", [(3, 0, 0), (0, 2, 0), (0, 0, 2), (2, 1, 1)])
def test_plain_scan_matches_reference_bitwise(kind, n, data, schedule, monoids):
    pid, level = forest(kind, n, seed=n)
    wdp = values(data, n, sum(monoids), seed=7)
    assert_bitwise(port(wdp, pid, level, monoids, schedule),
                   reference(wdp, pid, level, monoids, schedule))


def test_doubling_turns_negative_zero_sums_positive():
    """The doubling schedule combines with the identity where the pointer
    left the forest, as the reference does: -0.0 + 0.0 = +0.0, so a root's
    -0.0 sum turns +0.0 in the first round.  The level schedule never
    combines a root, so its -0.0 stays."""
    pid, level = forest("random", 50, seed=1)
    wdp = np.full((50, 1), -0.0, np.float32)
    roots = pid < 0
    lev = port(wdp, pid, level, (1, 0, 0), "level")
    dbl = port(wdp, pid, level, (1, 0, 0), "doubling")
    assert np.all(np.signbit(lev[roots])) and not np.any(np.signbit(dbl[roots]))


@pytest.mark.parametrize("kind", ["random", "chain", "star"])
def test_level_layout(kind):
    pid, level = forest(kind, 200, seed=3)
    order, ptr = level_layout(level)
    assert order.dtype == ptr.dtype == np.int32
    assert order.shape == (200,) and ptr.shape == (201,)
    assert np.array_equal(np.sort(order), np.arange(200))
    assert np.all(np.diff(level[order]) >= 0)  # sorted by level
    for lv in range(int(level.max()) + 1):  # stable: ids ascend within a level
        members = order[ptr[lv]:ptr[lv + 1]]
        assert np.all(level[members] == lv) and np.all(np.diff(members) > 0)
    assert np.all(ptr[int(level.max()) + 1:] == 200)
    # every parent sits exactly one level up: what the scan relies on
    has = pid >= 0
    assert np.array_equal(level[pid[has]] + 1, level[has])


def test_wrapper_rejects_what_the_kernel_does_not_take():
    pid, level = forest("random", 20, seed=2)
    order, ptr = (torch.from_numpy(a) for a in level_layout(level))
    p = torch.from_numpy(pid)
    w = torch.zeros((20, 3))
    mx = int(level.max())
    with pytest.raises(ValueError, match="monoids"):
        k.inherit_scan(w, p, order, ptr, max_level=mx, monoids=(1, 1, 0))
    with pytest.raises(TypeError):
        k.inherit_scan(w.double(), p, order, ptr, max_level=mx, monoids=(3, 0, 0))
    with pytest.raises(ValueError, match="level_ptr"):
        k.inherit_scan(w, p, order, ptr[:-1], max_level=mx, monoids=(3, 0, 0))
    with pytest.raises(ValueError, match="max_level"):
        k.inherit_scan(w, p, order, ptr, max_level=20, monoids=(3, 0, 0))
    with pytest.raises(ValueError, match="schedule"):
        inherit(w, p, order, ptr, mx, (3, 0, 0), "sweep")
    before = k.inherit_scan.launches
    k.inherit_scan(w, p, order, ptr, max_level=mx, monoids=(3, 0, 0))
    assert k.inherit_scan.launches == before  # the CPU takes the plain version

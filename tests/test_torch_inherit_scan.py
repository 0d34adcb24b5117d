"""The inheritance scan's plain versions (level and doubling schedules)
and the chain layout the card's kernel walks, against the reference's
``_inherit_scan``, on the CPU.

Both schedules combine each vertex with exactly the values the reference
combines it with, in the same order, so the results agree bit for bit on
any float32 data given the same partials — normal values, NaN in the
min/max columns, and the -0.0 that the doubling schedule's combine with
the identity turns into +0.0.  So does a walk down the chain layout in
the kernel's order (chain by chain, each chain head to tail, carrying the
running value), written here in NumPy.  The forests are made with numpy
from a seed and handed to both packages as arrays.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.core import engine_jax as ej  # noqa: E402

from repro_torch.kernels.inherit_scan import inherit_scan as k  # noqa: E402
from repro_torch.kernels.inherit_scan.ops import (  # noqa: E402
    chain_layout,
    forest_layout,
    inherit,
    level_layout,
    subtree_sizes,
)

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
    elif kind == "spine":  # a path over 8 % of the vertices, bushes hanging off it
        parent = (rng.random(n) * np.arange(n)).astype(np.int64)
        spine = max(2, n * 8 // 100)
        parent[:spine] = np.arange(-1, spine - 1)
        bush = np.arange(spine, n)
        near = rng.random(bush.size) < 0.5
        parent[bush[near]] = rng.integers(0, spine, int(near.sum()))
        parent[bush[rng.random(bush.size) < 0.01]] = -1  # a few more roots
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


def on_cpu(pid, level):
    """The forest's :class:`Forest` as CPU tensors."""
    return forest_layout(pid, level).map(torch.from_numpy)


def port(wdp, pid, level, monoids, schedule):
    return inherit(torch.from_numpy(wdp), on_cpu(pid, level), monoids, schedule).numpy()


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


@pytest.mark.parametrize("kind,n", [("random", 200), ("chain", 50), ("random", 1)])
def test_forest_layout_holds_both_layouts(kind, n):
    pid, level = forest(kind, n, seed=4)
    f = forest_layout(pid, level)
    order, ptr = level_layout(level)
    chains = chain_layout(pid, level)
    assert f.max_level == int(level.max()) and f.chains.count == chains.count
    for got, want in zip(f.arrays(), (pid, order, ptr, *chains[:3])):
        assert got.dtype == np.int32 and np.array_equal(got, want)
    t = f.map(torch.from_numpy)
    assert t.max_level == f.max_level and t.chains.count == f.chains.count
    assert all(isinstance(a, torch.Tensor) for a in t.arrays())


def test_wrapper_rejects_what_the_kernel_does_not_take():
    pid, level = forest("random", 20, seed=2)
    f = on_cpu(pid, level)
    w = torch.zeros((20, 3))
    with pytest.raises(ValueError, match="monoids"):
        k.inherit_scan(w, f, monoids=(1, 1, 0))
    with pytest.raises(TypeError):
        k.inherit_scan(w.double(), f, monoids=(3, 0, 0))
    with pytest.raises(ValueError, match="level_ptr"):
        k.inherit_scan(w, f._replace(level_ptr=f.level_ptr[:-1]), monoids=(3, 0, 0))
    with pytest.raises(ValueError, match="max_level"):
        k.inherit_scan(w, f._replace(max_level=20), monoids=(3, 0, 0))
    with pytest.raises(ValueError, match="schedule"):
        inherit(w, f, (3, 0, 0), "sweep")
    before = k.inherit_scan.launches
    k.inherit_scan(w, f, monoids=(3, 0, 0))
    assert k.inherit_scan.launches == before  # the CPU takes the plain version


def chain_walk(wdp, chains, pid, monoids):
    """The kernel's schedule in NumPy: chain by chain in layout order, each
    head to tail, carrying the running value; a head starts from its
    parent's finished value, a root's head keeps its partial."""
    n_sum, n_min, _ = monoids
    fold = (np.add, np.minimum, np.maximum)
    ops = [fold[0]] * n_sum + [fold[1]] * n_min + [fold[2]] * (wdp.shape[1] - n_sum - n_min)
    out = np.full_like(wdp, np.float32(12345.0))
    for k in range(chains.count):
        lo, hi = chains.ptr[k], chains.ptr[k + 1]
        hp = chains.head_parent[k]
        acc = None if hp < 0 else out[chains.vertices[hp]].copy()
        for v in chains.vertices[lo:hi]:
            if acc is None:
                acc = wdp[v].copy()
            else:
                assert pid[v] >= 0
                acc = np.array([op(w, a) for op, w, a in zip(ops, wdp[v], acc)], np.float32)
            out[v] = acc
    return out


def light_edges(pid, level, chains):
    """int ``[n]``: the chain heads on each vertex's root path, its own
    root's chain not counted (the light edges the path crosses)."""
    n = pid.size
    head = np.zeros(n, bool)
    head[chains.vertices[chains.ptr[:chains.count]]] = True
    out = np.zeros(n, np.int64)
    for v in np.argsort(level, kind="stable"):
        if pid[v] >= 0:
            out[v] = out[pid[v]] + head[v]
    return out


@pytest.mark.parametrize("kind,n", [("random", 400), ("chain", 130), ("star", 300),
                                    ("spine", 600), ("random", 1)])
def test_chain_layout(kind, n):
    pid, level = forest(kind, n, seed=n + 1)
    cl = chain_layout(pid, level)
    assert cl.vertices.dtype == cl.ptr.dtype == cl.head_parent.dtype == np.int32
    assert cl.vertices.shape == cl.head_parent.shape == (n,) and cl.ptr.shape == (n + 1,)
    assert isinstance(cl.count, int) and 1 <= cl.count <= n
    assert np.array_equal(np.sort(cl.vertices), np.arange(n))  # every vertex once
    assert cl.ptr[0] == 0 and np.all(np.diff(cl.ptr[:cl.count + 1]) > 0)
    assert np.all(cl.ptr[cl.count:] == n) and np.all(cl.head_parent[cl.count:] == -1)
    size = subtree_sizes(pid, level)
    chain_of = np.repeat(np.arange(cl.count), np.diff(cl.ptr[:cl.count + 1]))
    pos = np.empty(n, np.int64)
    pos[cl.vertices] = np.arange(n)
    for k in range(cl.count):
        members = cl.vertices[cl.ptr[k]:cl.ptr[k + 1]]
        # contiguous from head to tail: each vertex the next one's parent
        assert np.array_equal(pid[members[1:]], members[:-1])
        hp, head = cl.head_parent[k], members[0]
        if pid[head] < 0:
            assert hp == -1
        else:  # the head's parent, in an earlier chain
            assert cl.vertices[hp] == pid[head] and chain_of[hp] < k
        # the chain goes on into the child with the largest subtree, ties by
        # id, and ends at a leaf
        assert not np.any(pid == members[-1])
        for a, b in zip(members[:-1], members[1:]):
            kids = np.flatnonzero(pid == a)
            best = kids[np.lexsort((kids, -size[kids]))][0]
            assert b == best
    # heads by level, then by id
    heads = cl.vertices[cl.ptr[:cl.count]]
    assert np.all(np.diff(level[heads] * n + heads) > 0)
    assert light_edges(pid, level, cl).max() <= int(np.floor(np.log2(n)))
    # subtree sizes: each vertex one more than its children's
    kids_sum = np.bincount(pid[pid >= 0], weights=size[pid >= 0], minlength=n)
    assert np.array_equal(size, 1 + kids_sum.astype(np.int64))


def test_chain_layout_on_a_spine_with_bushes():
    """The shape measured on the main path's DAG (one long chain, a few
    longer than 32, every root-to-leaf path through a few light edges)."""
    pid, level = forest("spine", 6000, seed=11)
    cl = chain_layout(pid, level)
    assert np.diff(cl.ptr[:cl.count + 1]).max() >= 6000 * 8 // 100
    assert light_edges(pid, level, cl).max() <= int(np.floor(np.log2(6000)))


@pytest.mark.parametrize("data", ["int", "normal", "nan", "negzero"])
@pytest.mark.parametrize("kind,n", [("random", 400), ("chain", 130), ("star", 300),
                                    ("spine", 500)])
@pytest.mark.parametrize("monoids", [(3, 0, 0), (0, 2, 0), (0, 0, 2), (2, 1, 1)])
def test_chain_walk_matches_reference_bitwise(kind, n, data, monoids):
    pid, level = forest(kind, n, seed=n)
    wdp = values(data, n, sum(monoids), seed=7)
    assert_bitwise(chain_walk(wdp, chain_layout(pid, level), pid, monoids),
                   reference(wdp, pid, level, monoids, "level"))


def test_wrapper_checks_the_chain_layout():
    """The layout's own check (what the card's path runs before a launch)
    refuses a layout that does not fit the forest; on the CPU the wrapper
    reads only the level layout, so a bad chain layout changes nothing."""
    pid, level = forest("random", 20, seed=2)
    f = on_cpu(pid, level)
    chains, cpu = f.chains, torch.device("cpu")
    chains.check(20, cpu)
    with pytest.raises(ValueError, match="chains.ptr"):
        chains._replace(ptr=chains.ptr[:-1]).check(20, cpu)
    with pytest.raises(TypeError):
        chains._replace(vertices=chains.vertices.long()).check(20, cpu)
    with pytest.raises(ValueError, match="chains.count"):
        chains._replace(count=21).check(20, cpu)
    with pytest.raises(ValueError, match="on cpu, expected meta"):
        chains.check(20, torch.device("meta"))
    w, kw = torch.zeros((20, 3)), dict(monoids=(3, 0, 0))
    with pytest.raises(ValueError, match="unsupported device"):
        k.inherit_scan(w.to("meta"), f.map(lambda t: t.to("meta")), **kw)
    want = k.inherit_scan(w, f, **kw)
    bad = f._replace(chains=chains._replace(ptr=chains.ptr[:-1], count=21))
    assert torch.equal(k.inherit_scan(w, bad, **kw), want)

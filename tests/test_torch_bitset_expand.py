"""Kernel K2 (bitset BFS hop), port vs reference, on the CPU.

The port's ``khop_reach`` (its plain version here: the tensors lie on the
CPU) is bit-equal to the reference's Pallas ``khop_reach`` in interpret
mode (compared as int32 views of the same words), to the NumPy
``khop_reach_ref`` (the port's copy, itself equal to the reference's) and
to the host ``khop_window_single`` BFS.  Every hop's occupancy mask equals
its recomputation from the words; the expand plan's arrays equal the
reference's, and its run offsets equal a search over the valid rows.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import updates as r_updates  # noqa: E402
from repro.core.graph import Graph as RGraph  # noqa: E402
from repro.kernels.bitset_expand import ops as r_ops  # noqa: E402
from repro.kernels.bitset_expand.ref import khop_reach_ref as r_khop_reach_ref  # noqa: E402

from repro_torch.core import updates as p_updates  # noqa: E402
from repro_torch.core.windows import khop_window_single  # noqa: E402
from repro_torch.graphs.generators import erdos_renyi  # noqa: E402
from repro_torch.kernels.bitset_expand import bitset_expand as p_k2  # noqa: E402
from repro_torch.kernels.bitset_expand import ops as p_ops  # noqa: E402
from repro_torch.kernels.bitset_expand.ref import khop_reach_ref  # noqa: E402


def _dst_sorted_edges(g):
    src = np.concatenate([g.src, g.dst])
    dst = np.concatenate([g.dst, g.src])
    order = np.argsort(dst, kind="stable")
    return src[order], dst[order]


def _mask_of(words: np.ndarray) -> np.ndarray:
    """The occupancy mask of ``[n, W]`` words, in NumPy: bit g of word
    g // 32 set iff words 4g..4g+3 are not all zero."""
    n, w = words.shape
    nz = (words.reshape(n, w // 4, 4) != 0).any(axis=2)
    mw = -(-(w // 4) // 32)
    nz = np.pad(nz, ((0, 0), (0, mw * 32 - nz.shape[1])))
    return np.packbits(nz.reshape(n, mw, 32), axis=2, bitorder="little").view(
        np.uint32).reshape(n, mw).view(np.int32)


@pytest.mark.parametrize("n,deg,k", [(200, 4.0, 1), (300, 6.0, 2), (150, 3.0, 3)])
def test_khop_reach_matches_reference(n, deg, k):
    g = erdos_renyi(n, deg, seed=int(n + k))
    es, ed = _dst_sorted_edges(g)
    sources = np.arange(min(96, n), dtype=np.int32)
    pplan = p_ops.build_expand_plan(es, ed, n, tm=256, ts=256, torch_device="cpu")
    got = p_ops.khop_reach(pplan, n, sources, k).numpy()
    assert got.dtype == np.int32 and got.shape == (n, 128)
    rplan = r_ops.build_expand_plan(es, ed, n, tm=256, ts=256)
    ref = np.asarray(r_ops.khop_reach(rplan, n, sources, k))
    assert np.array_equal(got, ref.view(np.int32))
    reach0 = np.zeros((n, 128), dtype=np.uint32)
    cols = np.arange(sources.size)
    reach0[sources, cols // 32] |= np.uint32(1) << (cols % 32).astype(np.uint32)
    ref_np = khop_reach_ref(reach0, es, ed, n, k)
    assert np.array_equal(ref_np, r_khop_reach_ref(reach0, es, ed, n, k))
    assert np.array_equal(got.view(np.uint32), ref_np)


def test_khop_reach_matches_host_bfs():
    g = erdos_renyi(250, 5.0, seed=42)
    es, ed = _dst_sorted_edges(g)
    plan = p_ops.build_expand_plan(es, ed, g.n, torch_device="cpu")
    got = p_ops.khop_reach(plan, g.n, np.arange(64, dtype=np.int32), 2).numpy()
    words = got.view(np.uint32)
    for v in (0, 17, 31, 32, 63):
        members = np.flatnonzero((words[:, v // 32] >> np.uint32(v % 32)) & 1)
        assert np.array_equal(members, khop_window_single(g, 2, v))


def _case_edges(kind, n, rng):
    """dst-sorted (src, dst) of one case: an undirected ER graph,
    symmetrized; for ``no_in_edges`` a directed one whose vertices
    [n/3, 2n/3) and every multiple of 7 have no in-edges."""
    if kind == "no_in_edges":
        g = erdos_renyi(n, 5.0, directed=True, seed=n)
        keep = ~(((g.dst >= n // 3) & (g.dst < 2 * n // 3)) | (g.dst % 7 == 0))
        src, dst = g.src[keep], g.dst[keep]
        order = np.argsort(dst, kind="stable")
        return src[order], dst[order]
    return _dst_sorted_edges(erdos_renyi(n, 4.0, seed=n + 1))


# (kind, n, seeds, k): seeds 1, 250 and 4096; no seeds at all (an all-zero
# reach); destinations with no in-edges; n a multiple of 256 only once
K2_CASES = [("er", 300, 1, 1), ("er", 300, 1, 3), ("er", 1000, 250, 1),
            ("er", 1000, 250, 2), ("er", 1000, 250, 3), ("er", 4300, 4096, 1),
            ("er", 4300, 4096, 2), ("er", 700, 0, 2), ("no_in_edges", 900, 250, 1),
            ("no_in_edges", 900, 250, 3), ("no_in_edges", 512, 64, 2)]


@pytest.mark.parametrize("kind,n,n_seeds,k", K2_CASES)
def test_khop_reach_masked_matches_reference(kind, n, n_seeds, k):
    """The plain version with masks, hop by hop, against the reference's
    Pallas ``khop_reach`` (interpret mode, lanes = 128): words bit for bit,
    each mask equal to its recomputation from the words."""
    rng = np.random.default_rng(n + n_seeds + k)
    es, ed = _case_edges(kind, n, rng)
    seeds = np.sort(rng.choice(n, n_seeds, replace=False)).astype(np.int32)
    plan = p_ops.build_expand_plan(es, ed, n, torch_device="cpu")
    rplan = r_ops.build_expand_plan(es, ed, n, tm=256, ts=256)
    for hops in range(k + 1):
        got, mask = p_ops.khop_reach_masked(plan, n, seeds, hops)
        ref = np.asarray(r_ops.khop_reach(rplan, n, seeds, hops))
        assert np.array_equal(got.numpy(), ref.view(np.int32)), hops
        assert np.array_equal(mask.numpy(), _mask_of(got.numpy())), hops
    if kind == "no_in_edges":
        lonely = np.setdiff1d(np.arange(n), ed)
        assert np.array_equal(got.numpy()[lonely], p_ops.seed_bitsets(n, seeds)[lonely])


@pytest.mark.parametrize("words", [4, 8, 132])
@pytest.mark.parametrize("k", [1, 2])
def test_khop_reach_masked_other_widths(words, k):
    """W = 4, 8, 132 (one mask word covering 1 or 2 groups; two mask words,
    the second covering one group) against the NumPy ``khop_reach_ref``."""
    n = 777
    rng = np.random.default_rng(words + k)
    es, ed = _dst_sorted_edges(erdos_renyi(n, 3.0, seed=words))
    seeds = rng.choice(n, min(n, 32 * words), replace=False)
    plan = p_ops.build_expand_plan(es, ed, n, torch_device="cpu")
    got, mask = p_ops.khop_reach_masked(plan, n, seeds, k, lanes=words)
    reach0 = p_ops.seed_bitsets(n, seeds, words)
    r0, m0 = p_ops.khop_reach_masked(plan, n, seeds, 0, lanes=words)
    assert np.array_equal(r0.numpy(), reach0)
    assert np.array_equal(m0.numpy(), _mask_of(reach0))
    ref = khop_reach_ref(reach0.view(np.uint32), es, ed, n, k)
    assert np.array_equal(got.numpy().view(np.uint32), ref)
    assert np.array_equal(mask.numpy(), _mask_of(got.numpy()))


@pytest.mark.parametrize("words", [4, 8, 128, 132])
def test_bitset_mask_plain_matches_numpy(words):
    """The mask of random sparse words: the plain version (the mask-less
    call's CPU path) equals the NumPy recomputation, high bits included."""
    rng = np.random.default_rng(words)
    w = rng.integers(-(2**31), 2**31, (300, words)).astype(np.int32)
    w[rng.random(w.shape) < 0.9] = 0
    w[:, -4:] = np.where(np.arange(300)[:, None] % 2, w[:, -4:], 0)
    got = p_k2.bitset_mask(torch.from_numpy(w))
    assert got.dtype == torch.int32 and got.shape == (300, p_k2.mask_words(words))
    assert np.array_equal(got.numpy(), _mask_of(w))


def test_expand_without_mask_equals_with_mask():
    """``bitset_expand`` without a mask computes one: same words and mask."""
    n = 600
    es, ed = _dst_sorted_edges(erdos_renyi(n, 4.0, seed=3))
    plan = p_ops.build_expand_plan(es, ed, n, torch_device="cpu")
    r0, m0 = p_ops.khop_reach_masked(plan, n, np.arange(0, n, 3), 0)
    a, ma = p_ops.bitset_expand(plan, r0, m0)
    b, mb = p_ops.bitset_expand(plan, r0)
    assert torch.equal(a, b) and torch.equal(ma, mb)


@pytest.mark.parametrize("n,directed", [(300, False), (1000, True), (4300, False)])
def test_expand_plan_arrays_and_run_offsets(n, directed):
    """Every tile-plan array equals the reference's ``build_expand_plan``;
    ``row_ptr`` is ``np.searchsorted`` over the valid rows' destinations,
    and ``pad_before`` moves each run onto its padded rows."""
    g = erdos_renyi(n, 4.0, directed=directed, seed=n)
    es, ed = _dst_sorted_edges(g)
    plan = p_ops.build_expand_plan(es, ed, n, torch_device="cpu")
    rplan = r_ops.build_expand_plan(es, ed, n)
    for f in ("gather_padded", "seg_tiles", "m2out", "first_visit"):
        assert np.array_equal(getattr(plan, f).numpy(), np.asarray(getattr(rplan, f))), f
    for f in ("num_segments", "num_out_tiles", "tm", "ts"):
        assert getattr(plan, f) == getattr(rplan, f), f
    sid = plan.seg_tiles.reshape(-1).numpy()
    valid = np.flatnonzero(sid >= 0)
    row_ptr = plan.row_ptr.numpy()
    assert row_ptr.dtype == np.int32
    assert np.array_equal(row_ptr, np.searchsorted(sid[valid], np.arange(n + 1)))
    pad = plan.pad_before.numpy()[np.arange(n) // plan.ts]
    pos = np.concatenate([np.arange(row_ptr[v], row_ptr[v + 1]) + pad[v] for v in range(n)])
    assert np.array_equal(pos, valid)
    assert plan.array_nbytes()["row_ptr"] == 4 * (n + 1)


def _stream_batch(g, rng, n_ins, n_del):
    s = rng.integers(0, g.n, n_ins)
    d = rng.integers(0, g.n, n_ins)
    e = rng.choice(g.n_edges, n_del, replace=False)
    return (np.concatenate([s, g.src[e]]), np.concatenate([d, g.dst[e]]),
            np.concatenate([np.ones(n_ins, np.int8), -np.ones(n_del, np.int8)]))


@pytest.mark.parametrize("directed", [False, True])
def test_affected_owners_device_route_over_stream(directed):
    """20 batches: the port's device route (K2's plain version on the CPU)
    equals the reference's Pallas route and the port's host NumPy route."""
    g = erdos_renyi(400, 4.0, directed=directed, seed=11)
    rng = np.random.default_rng(5)
    for step in range(20):
        s, d, op = _stream_batch(g, rng, 8, 3)
        g = p_updates.apply_batch(g, p_updates.UpdateBatch(s, d, op))
        seeds = np.concatenate([s, d]) if not directed else s
        k = 2 + step % 2
        dev = p_updates.affected_owners_khop_multi(g, k, seeds, use_device=True,
                                                   torch_device="cpu")
        host = p_updates.affected_owners_khop_multi(g, k, seeds, use_device=False)
        rg = RGraph(g.n, g.src, g.dst, directed=g.directed)
        ref = r_updates.affected_owners_khop_multi(rg, k, seeds, use_device=True)
        assert np.array_equal(dev, host), step
        assert np.array_equal(dev, ref), step


def test_wrapper_rejects_what_the_kernel_does_not_take():
    n = 300
    es, ed = _dst_sorted_edges(erdos_renyi(n, 4.0, seed=9))
    plan = p_ops.build_expand_plan(es, ed, n, torch_device="cpu")
    r = torch.zeros((n, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="mask"):
        p_ops.bitset_expand(plan, r, torch.zeros((n, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match="16-byte"):
        p_ops.bitset_expand(plan, torch.zeros((n, 6), dtype=torch.int32))
    with pytest.raises(ValueError, match="row_ptr"):
        p_ops.bitset_expand(plan, r[: n - 1])
    with pytest.raises(TypeError):
        p_ops.bitset_expand(plan, r.to(torch.int64))
    with pytest.raises(ValueError, match="device"):
        p_k2.bitset_mask(torch.zeros((n, 128), dtype=torch.int32, device="meta"))

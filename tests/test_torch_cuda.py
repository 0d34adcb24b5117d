"""The CUDA kernels against their plain versions, on the card.

These need a GPU with ``nvcc`` (the kernels build at first use) and skip
without one; run them on the card with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("n,m,s,d", [(50, 200, 17, 1), (1000, 5000, 600, 8),
                                     (300, 700, 513, 3), (64, 0, 10, 4),
                                     (2000, 3000, 1200, 130)])
def test_segment_sum_kernel_matches_plain(cuda, n, m, s, d):
    from repro_torch.kernels.segment_reduce import ops
    from repro_torch.kernels.segment_reduce.segment_reduce import segment_sum_tiled

    rng = np.random.default_rng(n + m)
    seg = np.sort(rng.integers(0, s, m)).astype(np.int32)
    gidx = rng.integers(0, n, m).astype(np.int32)
    cpu_plan = ops.build_tile_plan(gidx, seg, s, torch_device="cpu")
    plan = ops.build_tile_plan(gidx, seg, s, torch_device=cuda)
    for vals in (rng.integers(0, 100, (n, d)), rng.normal(size=(n, d))):
        v = torch.from_numpy(vals.astype(np.float32))
        before = segment_sum_tiled.launches
        got = ops.segment_sum(plan, v.to(cuda))
        assert segment_sum_tiled.launches == before + 1
        again = ops.segment_sum(plan, v.to(cuda))
        ref = ops.segment_sum(cpu_plan, v)
        assert torch.equal(got, again)  # deterministic: no atomics
        torch.testing.assert_close(got.cpu(), ref, rtol=1e-5, atol=1e-5)
        if vals.dtype.kind == "i":
            assert torch.equal(got.cpu(), ref)


def _k1_rows(kind, rng):
    """(gather, sorted segment ids, segments, headroom) of one K1 plan case."""
    if kind == "long_run":  # one segment of 120,000 rows: longer than any block
        seg = np.concatenate([np.full(120_000, 3), np.sort(rng.integers(4, 900, 30_000))])
        return rng.integers(0, 2000, seg.size), seg, 900, 0.0
    if kind == "empty":  # most segments and most output tiles empty
        return rng.integers(0, 2000, 300), np.sort(rng.integers(0, 5000, 300)), 5000, 0.0
    if kind == "large":  # 2^21+ plan rows: the kernel's large-plan block size
        return (rng.integers(0, 100_000, 2_500_000),
                np.sort(rng.integers(0, 200_000, 2_500_000)), 200_000, 0.3)
    # all-pad tiles in every group ("headroom") or none ("mixed")
    return (rng.integers(0, 2000, 5000), np.sort(rng.integers(0, 600, 5000)), 600,
            1.0 if kind == "headroom" else 0.0)


def _k1_check(got, plain, mass, n_sum, exact):
    """Sum columns within 1e-5 of each segment's sum of |terms| (bitwise
    when every partial sum is exact); min/max columns bitwise."""
    if exact:
        assert torch.equal(got, plain)
    else:
        assert bool(((got[:, :n_sum] - plain[:, :n_sum]).abs()
                     <= 1e-5 * mass[:, :n_sum]).all())
        assert torch.equal(got[:, n_sum:], plain[:, n_sum:])


# (kind, monoids, route): the narrow route's cases (C = 130 there with the
# threshold raised), then the wide route at C = 33, 100, 128 and
# 1,433, the route table's choice for each
K1_CUDA_CASES = [
    ("mixed", (1, 1, 1), "narrow"), ("mixed", (0, 1, 0), "narrow"),
    ("mixed", (0, 0, 2), "narrow"), ("headroom", (2, 1, 1), "narrow"),
    ("long_run", (2, 1, 1), "narrow"), ("long_run", (0, 0, 1), "narrow"),
    ("empty", (1, 1, 1), "narrow"), ("mixed", (64, 33, 33), "narrow"),
    ("large", (1, 0, 0), "narrow"), ("large", (1, 1, 1), "narrow"),
    ("mixed", (33, 0, 0), "wide"), ("headroom", (100, 0, 0), "wide"),
    ("mixed", (128, 0, 0), "wide"), ("long_run", (128, 0, 0), "wide"),
    ("long_run", (64, 33, 33), "wide"), ("empty", (64, 33, 33), "wide"),
    ("empty", (1433, 0, 0), "wide"), ("mixed", (1433, 0, 0), "wide"),
    ("headroom", (11, 11, 11), "wide"), ("large", (100, 0, 0), "wide"),
]


@pytest.mark.parametrize("kind,monoids,kernel", K1_CUDA_CASES)
def test_segment_reduce_kernel_matches_plain(cuda, monkeypatch, kind, monoids, kernel):
    from _k1_wide_model import wide_model

    from repro_torch.kernels.segment_reduce import ops
    from repro_torch.kernels.segment_reduce import segment_reduce as k1mod
    from repro_torch.kernels.segment_reduce.segment_reduce import (
        route,
        segment_reduce_plain,
        segment_reduce_tiled,
        segment_sum_tiled,
        wide_slice_rows,
    )

    rng = np.random.default_rng(sum(monoids) + len(kind))
    gidx, seg, s, headroom = _k1_rows(kind, rng)
    plan = ops.build_tile_plan(gidx.astype(np.int32), seg, s, headroom=headroom,
                               torch_device=cuda)
    args = (plan.gather_padded, plan.seg_tiles, plan.m2out)
    kw = dict(num_out_tiles=plan.num_out_tiles, tm=plan.tm, ts=plan.ts)
    c, n = sum(monoids), int(gidx.max()) + 1
    # the route table's choice, or the narrow route past its threshold
    assert kernel == "narrow" or route(c) == "wide"
    if route(c) != kernel:
        monkeypatch.setattr(k1mod, "NARROW_MAX_C", c)
    for vals in (rng.integers(0, 100, (n, c)), rng.normal(size=(n, c))):
        v = torch.from_numpy(vals.astype(np.float32)).to(cuda)
        before, by_route = segment_sum_tiled.launches, dict(segment_sum_tiled.launches_by_route)
        got = segment_reduce_tiled(v, *args, monoids=monoids, **kw)
        again = segment_reduce_tiled(v, *args, monoids=monoids, **kw)
        torch.cuda.synchronize()
        assert segment_sum_tiled.launches == before + 2
        assert segment_sum_tiled.launches_by_route == {**by_route,
                                                       kernel: by_route[kernel] + 2}
        assert torch.equal(got, again)  # deterministic: no atomics
        plain = segment_reduce_plain(v, plan.gather_padded, plan.seg_tiles,
                                     monoids=monoids, num_out_tiles=plan.num_out_tiles,
                                     ts=plan.ts)
        mass = segment_reduce_plain(v.abs(), plan.gather_padded, plan.seg_tiles,
                                    monoids=monoids, num_out_tiles=plan.num_out_tiles,
                                    ts=plan.ts)
        _k1_check(got, plain, mass, monoids[0], vals.dtype.kind == "i")
        # every cell of an empty segment holds its monoid's identity
        empty = torch.from_numpy(np.bincount(seg, minlength=got.shape[0]) == 0).to(cuda)
        ident = torch.tensor([0.0] * monoids[0] + [float("inf")] * monoids[1]
                             + [float("-inf")] * monoids[2], device=cuda)
        assert torch.equal(got[empty], ident.expand(int(empty.sum()), c))
        if kernel == "narrow":
            continue
        # the wide route: bitwise its NumPy model (float32 in the kernels'
        # order), the pre-gathered form and 4-byte lanes (values not 16-byte
        # aligned) the same function bit for bit
        if kind != "large":
            model, _ = wide_model(vals.astype(np.float32), plan.gather_padded.cpu().numpy(),
                                  plan.seg_tiles.cpu().numpy(), plan.m2out.cpu().numpy(),
                                  monoids, plan.num_out_tiles, plan.tm, plan.ts,
                                  wide_slice_rows(plan.seg_tiles.numel()))
            assert torch.equal(got.cpu(), torch.from_numpy(model))
        rows = v.index_select(0, plan.gather_padded.long())
        assert torch.equal(segment_reduce_tiled(rows, None, plan.seg_tiles, plan.m2out,
                                                monoids=monoids, **kw), got)
        odd = torch.empty(v.numel() + 1, device=cuda)[1:].view(v.shape)
        odd.copy_(v)
        assert torch.equal(segment_reduce_tiled(odd, *args, monoids=monoids, **kw), got)


def test_segment_reduce_kernel_propagates_nan(cuda):
    from repro_torch.kernels.segment_reduce import ops
    from repro_torch.kernels.segment_reduce.segment_reduce import segment_reduce_plain

    rng = np.random.default_rng(3)
    gidx, seg, s, _ = _k1_rows("long_run", rng)
    vals = rng.integers(0, 100, (2000, 4)).astype(np.float32)
    vals[rng.integers(0, 2000, 40), rng.integers(0, 4, 40)] = np.nan
    cpu_plan = ops.build_tile_plan(gidx.astype(np.int32), seg, s, torch_device="cpu")
    plan = ops.build_tile_plan(gidx.astype(np.int32), seg, s, torch_device=cuda)
    got = ops.segment_reduce_multi(plan, torch.from_numpy(vals).to(cuda), (2, 1, 1))
    # the oracle on the CPU, whose scatter_reduce amin/amax keep NaN
    want = segment_reduce_plain(torch.from_numpy(vals), cpu_plan.gather_padded,
                                cpu_plan.seg_tiles, monoids=(2, 1, 1),
                                num_out_tiles=cpu_plan.num_out_tiles,
                                ts=cpu_plan.ts)[:s]
    assert bool(torch.isnan(want[:, 2:]).any())
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0, equal_nan=True)


def test_segment_reduce_wide_kernel_propagates_nan(cuda):
    """The wide route keeps NaN in min/max as the CPU's plain version does,
    a run crossing many slices included."""
    from repro_torch.kernels.segment_reduce import ops
    from repro_torch.kernels.segment_reduce.segment_reduce import (
        segment_reduce_plain,
        segment_sum_tiled,
    )

    rng = np.random.default_rng(4)
    gidx, seg, s, _ = _k1_rows("long_run", rng)
    vals = rng.integers(0, 100, (2000, 40)).astype(np.float32)
    vals[rng.integers(0, 2000, 40), rng.integers(20, 40, 40)] = np.nan
    cpu_plan = ops.build_tile_plan(gidx.astype(np.int32), seg, s, torch_device="cpu")
    plan = ops.build_tile_plan(gidx.astype(np.int32), seg, s, torch_device=cuda)
    before = segment_sum_tiled.launches_by_route["wide"]
    got = ops.segment_reduce_multi(plan, torch.from_numpy(vals).to(cuda), (20, 10, 10))
    assert segment_sum_tiled.launches_by_route["wide"] == before + 1
    want = segment_reduce_plain(torch.from_numpy(vals), cpu_plan.gather_padded,
                                cpu_plan.seg_tiles, monoids=(20, 10, 10),
                                num_out_tiles=cpu_plan.num_out_tiles,
                                ts=cpu_plan.ts)[:s]
    assert bool(torch.isnan(want[:, 20:]).any())
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0, equal_nan=True)


def test_session_run_makes_two_k1_launches(cuda):
    """A plan without ELL layouts: every channel of run() and run_many()
    rides one K1 launch per pass."""
    from repro_torch.core import api
    from repro_torch.graphs import generators as gen
    from repro_torch.kernels.segment_reduce.segment_reduce import segment_sum_tiled

    g = gen.with_random_attrs(gen.barabasi_albert(400, 2, seed=7), seed=2)
    aggs = ("sum", "count", "avg", "min", "max")
    sess = api.Session(g, [api.QuerySpec(api.KHopWindow(2), a) for a in aggs],
                       torch_device=cuda)
    cpu = api.Session(g, [api.QuerySpec(api.KHopWindow(2), a) for a in aggs],
                      torch_device="cpu")
    (state,) = sess._states.values()
    assert state.plan.p1_ell is None
    before = segment_sum_tiled.launches
    got = sess.run()
    assert segment_sum_tiled.launches == before + 2
    vb = np.random.default_rng(5).integers(0, 100, (8, g.n)).astype(np.float64)
    many = sess.run_many(vb)
    assert segment_sum_tiled.launches == before + 4
    for a, x, y in zip(aggs, got, cpu.run()):
        assert np.array_equal(x, y), a
    for a, x, y in zip(aggs, many, cpu.run_many(vb)):
        assert np.array_equal(x, y), a


def _k2_edges(kind, n):
    """dst-sorted (src, dst): a symmetrized undirected ER graph of degree
    4 (``er``), 6 (``er6``) or 10 (``er10``), or for ``no_in_edges`` a
    directed one whose vertices [n/3, 2n/3) and every multiple of 7 have no
    in-edges."""
    from repro_torch.graphs.generators import erdos_renyi

    if kind == "no_in_edges":
        g = erdos_renyi(n, 5.0, directed=True, seed=n)
        keep = ~(((g.dst >= n // 3) & (g.dst < 2 * n // 3)) | (g.dst % 7 == 0))
        src, dst = g.src[keep], g.dst[keep]
    else:
        g = erdos_renyi(n, {"er": 4.0, "er6": 6.0, "er10": 10.0}[kind], seed=n)
        src = np.concatenate([g.src, g.dst])
        dst = np.concatenate([g.dst, g.src])
    order = np.argsort(dst, kind="stable")
    return src[order], dst[order]


# (kind, n, seeds, k, W): the CPU tests' cases (seeds 1, 250, 4096, none;
# destinations with no in-edges; n mostly not a multiple of 256), the three
# whole-graph sweeps this test first held (degree 4, 6 and 10), and W = 4, 8,
# 132
K2_CUDA_CASES = [("er", 300, 1, 1, 128), ("er", 300, 1, 3, 128), ("er", 1000, 250, 3, 128),
                 ("er", 4300, 4096, 2, 128), ("er", 700, 0, 2, 128),
                 ("no_in_edges", 900, 250, 3, 128), ("no_in_edges", 512, 64, 2, 128),
                 ("er", 200, 200, 1, 128), ("er6", 300, 300, 2, 128),
                 ("er10", 3000, 3000, 2, 128), ("er", 777, 128, 2, 4),
                 ("er", 777, 256, 2, 8), ("er", 777, 777, 2, 132),
                 ("er10", 50_000, 4096, 3, 128)]


@pytest.mark.parametrize("kind,n,n_seeds,k,words", K2_CUDA_CASES)
def test_bitset_expand_kernel_matches_plain(cuda, monkeypatch, kind, n, n_seeds, k, words):
    """K2 hop by hop against its plain version: words and masks bit for
    bit, one launch a hop, bitwise across two sweeps; the plain version is
    never reached with CUDA tensors."""
    from repro_torch.kernels.bitset_expand import bitset_expand as k2
    from repro_torch.kernels.bitset_expand import ops

    es, ed = _k2_edges(kind, n)
    seeds = np.sort(np.random.default_rng(n + k).choice(n, n_seeds, replace=False))
    plans = {dev: ops.build_expand_plan(es, ed, n, torch_device=dev) for dev in ("cpu", cuda)}
    want = [ops.khop_reach_masked(plans["cpu"], n, seeds, hops, words) for hops in range(k + 1)]
    monkeypatch.setattr(k2, "bitset_expand_plain", _fail)
    monkeypatch.setattr(k2, "bitset_mask_plain", _fail)
    before, masks_before = k2.bitset_expand_tiled.launches, k2.bitset_mask.launches
    r, m = ops.khop_reach_masked(plans[cuda], n, seeds, 0, words)
    for hops in range(1, k + 1):
        r, m = ops.bitset_expand(plans[cuda], r, m)
        torch.cuda.synchronize()
        assert torch.equal(r.cpu(), want[hops][0]), hops
        assert torch.equal(m.cpu(), want[hops][1]), hops
    assert k2.bitset_expand_tiled.launches == before + k
    assert k2.bitset_mask.launches == masks_before
    again, m2 = ops.khop_reach_masked(plans[cuda], n, seeds, k, words)
    assert torch.equal(again, r) and torch.equal(m2, m)


@pytest.mark.parametrize("words", [4, 8, 128, 132])
def test_bitset_expand_without_mask_runs_the_prepass(cuda, monkeypatch, words):
    """A call without a mask launches the pre-pass kernel once, then K2:
    the mask and the words equal the plain version's."""
    from repro_torch.kernels.bitset_expand import bitset_expand as k2
    from repro_torch.kernels.bitset_expand import ops

    n = 5000
    es, ed = _k2_edges("er", n)
    rng = np.random.default_rng(words)
    w = rng.integers(-(2**31), 2**31, (n, words)).astype(np.int32)
    w[rng.random(w.shape) < 0.97] = 0
    r = torch.from_numpy(w)
    want_mask = k2.bitset_mask_plain(r)
    want = ops.bitset_expand(ops.build_expand_plan(es, ed, n, torch_device="cpu"), r)
    plan = ops.build_expand_plan(es, ed, n, torch_device=cuda)
    monkeypatch.setattr(k2, "bitset_expand_plain", _fail)
    monkeypatch.setattr(k2, "bitset_mask_plain", _fail)
    before, masks_before = k2.bitset_expand_tiled.launches, k2.bitset_mask.launches
    assert torch.equal(k2.bitset_mask(r.to(cuda)).cpu(), want_mask)
    got, got_mask = ops.bitset_expand(plan, r.to(cuda))
    torch.cuda.synchronize()
    assert k2.bitset_mask.launches == masks_before + 2
    assert k2.bitset_expand_tiled.launches == before + 1
    assert torch.equal(got.cpu(), want[0]) and torch.equal(got_mask.cpu(), want[1])


def test_bitset_expand_build_has_no_spills_and_no_fallback(cuda, monkeypatch):
    """ptxas reports 0 spill bytes for both K2 functions; a library that
    cannot be loaded raises for CUDA tensors instead of falling back."""
    from repro_torch.kernels import build
    from repro_torch.kernels.bitset_expand import bitset_expand as k2
    from repro_torch.kernels.bitset_expand import ops

    build.build(("bitset_expand",))
    funcs = build.ptxas_report("bitset_expand")["functions"]
    assert len(funcs) == 2, funcs
    for fn, rep in funcs.items():
        assert rep.get("spill_stores") == 0 and rep.get("spill_loads") == 0, (fn, rep)
    es, ed = _k2_edges("er", 300)
    plan = ops.build_expand_plan(es, ed, 300, torch_device=cuda)
    r = torch.zeros((300, 128), dtype=torch.int32, device=cuda)

    def missing(name):
        raise RuntimeError(f"no library {name}")

    monkeypatch.setattr(k2._build, "load", missing)
    monkeypatch.setattr(k2, "bitset_expand_plain", _fail)
    with pytest.raises(RuntimeError, match="no library"):
        ops.bitset_expand(plan, r, torch.zeros((300, 1), dtype=torch.int32, device=cuda))


def _fail(*_a, **_k):
    raise AssertionError("a plain version was called for a CUDA tensor")


# (B, Hq, Hkv, S, D, causal): the first five from the first sweep; then the
# tensor-core route's edges: S around the 64-row query tile and the
# 128-key tile and one ragged long S, Hq / Hkv in {1, 2, 4, 8}, D 64 and 128;
# and one non-causal shape
K3_CASES = ([(2, 4, 2, 256, 64, True), (1, 8, 8, 130, 32, True), (2, 2, 1, 77, 16, True),
             (1, 4, 2, 1000, 128, True), (3, 6, 3, 1, 64, True)]
            + [(1, 2 * g, 2, s, d, True) for d in (64, 128) for g in (1, 2, 4, 8)
               for s in (1, 63, 64, 65, 127, 128, 129, 2048 + 17)]
            + [(2, 4, 2, 333, 64, False)])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,hq,hkv,s,d,causal", K3_CASES)
def test_flash_attention_kernel_matches_plain(cuda, monkeypatch, dtype, b, hq, hkv, s, d,
                                              causal):
    """K3 on the card, through the model's attention dispatch, against
    flash_torch on the same inputs: float32 within 1e-4; bf16 within the
    rounding the kernel adds (p rounded to bf16 moves an output by at most
    2**-8 of the attention-weighted mean of |v|, and both round their
    float32 result to bf16, one step of 2**-7 relative), plus 1e-4.  Both
    launches take the route the table names (bf16 with D 64 or 128: sm90)."""
    from repro_torch.kernels.flash_attention import flash_attention as fa_mod
    from repro_torch.kernels.flash_attention.ref import flash_torch
    from repro_torch.models import attention as attn_mod

    g = torch.Generator(device=cuda).manual_seed(s + d)
    q, k, v = (torch.randn((b, h, s, d), generator=g, device=cuda).to(dtype)
               for h in (hq, hkv, hkv))
    want = flash_torch(q, k, v, causal=causal)
    vbar = flash_torch(q.float(), k.float(), v.float().abs(), causal=causal)
    monkeypatch.setattr(fa_mod, "flash_attention_plain", _fail)
    monkeypatch.setattr(fa_mod, "flash_torch", _fail)
    monkeypatch.setattr(attn_mod, "flash_torch", _fail)
    monkeypatch.setattr(attn_mod, "mha_ref", _fail)
    path = "sm90" if dtype == torch.bfloat16 and d in (64, 128) else "simt"
    before = fa_mod.flash_attention.launches
    before_route = fa_mod.flash_attention.launches_by_route[path]
    got = attn_mod.attention(q, k, v, causal=causal)
    again = fa_mod.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa_mod.flash_attention.launches == before + 2
    assert fa_mod.flash_attention.launches_by_route[path] == before_route + 2
    assert got.dtype == dtype and torch.equal(got, again)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    else:
        tol = 2**-8 * vbar + 2**-7 * want.float().abs() + 1e-4
        assert bool(((got.float() - want.float()).abs() <= tol).all())
    with pytest.raises(NotImplementedError):
        attn_mod.attention(q, k, v, local_window=8)


@pytest.mark.parametrize("b,f,k", [(64, 39, 10), (100, 8, 16), (256, 5, 3), (262144, 39, 10)])
def test_fm_interaction_kernel_matches_plain(cuda, monkeypatch, b, f, k):
    """K4 against its plain version within 1e-5 of each row's sum of
    |terms| (float32 sums in another order); bitwise across launches."""
    from repro_torch.kernels.fm_interaction import fm_interaction as fm_mod
    from repro_torch.kernels.fm_interaction.ops import fm_second_order

    g = torch.Generator(device=cuda).manual_seed(b)
    emb = torch.randn((b, f, k), generator=g, device=cuda)
    want = fm_mod.fm_interaction_plain(emb)
    mass = 0.5 * (emb.abs().sum(1).square() + emb.square().sum(1)).sum(-1)
    monkeypatch.setattr(fm_mod, "fm_interaction_plain", _fail)
    before = fm_mod.fm_interaction.launches
    got = fm_second_order(emb)
    again = fm_mod.fm_interaction(emb)
    torch.cuda.synchronize()
    assert fm_mod.fm_interaction.launches == before + 2
    assert torch.equal(got, again)
    assert bool(((got - want).abs() <= 1e-5 * mass).all())


def test_lm_prefill_launches_k3_per_layer(cuda):
    """The SMOKE qwen3 prefill on the card: one K3 launch per layer, and
    logits close to the plain backend's (the repo's bf16 tolerance)."""
    from repro_torch.configs.qwen3_0p6b import SMOKE
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention, route
    from repro_torch.models import transformer as T

    params = T.init(torch.Generator(device=cuda).manual_seed(0), SMOKE)
    toks = torch.randint(0, SMOKE.vocab, (2, 300), device=cuda)
    path = route(SMOKE.cdtype, SMOKE.head_dim)
    before = flash_attention.launches
    before_route = flash_attention.launches_by_route[path]
    _, logits = T.prefill(params, toks, SMOKE)
    assert flash_attention.launches == before + SMOKE.n_layers
    assert flash_attention.launches_by_route[path] == before_route + SMOKE.n_layers
    _, plain = T.prefill(params, toks, SMOKE, attn_backend="flash_torch")
    torch.testing.assert_close(logits, plain, atol=0.06, rtol=0.05)


def _scan_forest(kind, n, rng):
    """(pid, level) int32 of a PID forest, ids relabelled at random."""
    if kind == "chain":
        parent = np.arange(-1, n - 1)
    elif kind == "wide":  # 7 roots, every other vertex at level 1
        parent = rng.integers(0, 7, n)
        parent[:7] = -1
    elif kind == "star":  # one root, every other vertex at level 1
        parent = np.zeros(n, np.int64)
        parent[0] = -1
    elif kind == "spine":  # a path over 8 % of the vertices, bushes hanging off it
        parent = (rng.random(n) * np.arange(n)).astype(np.int64)
        spine = n * 8 // 100
        parent[:spine] = np.arange(-1, spine - 1)
        bush = np.arange(spine, n)  # each bush vertex hangs near a spine vertex
        near = rng.random(bush.size) < 0.5
        parent[bush[near]] = rng.integers(0, spine, int(near.sum()))
        parent[bush[rng.random(bush.size) < 0.0005]] = -1  # a few more roots
    else:
        parent = (rng.random(n) * np.arange(n)).astype(np.int64)
        parent[(rng.random(n) < 0.02) | (np.arange(n) == 0)] = -1
    level = np.zeros(n, np.int64)
    for v in range(n):
        if parent[v] >= 0:
            level[v] = level[parent[v]] + 1
    perm = rng.permutation(n)
    pid = np.full(n, -1, np.int32)
    pid[perm[parent >= 0]] = perm[parent[parent >= 0]]
    lv = np.empty(n, np.int32)
    lv[perm] = level
    return pid, lv


def _assert_same_bits(got, want):
    """NaN in the same places, the same bits everywhere else (so +0.0 and
    -0.0 differ)."""
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got.view(torch.int32)[~nan], want.view(torch.int32)[~nan])


@pytest.mark.parametrize("kind,n,monoids,data", [
    ("chain", 5000, (1, 1, 1), "nan"),  # depth 4,999: one chain
    ("wide", 100_000, (2, 0, 0), "nan"),  # one level of 99,993 vertices: 99,993 chains
    ("random", 20_000, (4, 2, 3), "nan"),  # mixed monoids, 9 columns
    ("random", 3000, (100, 50, 50), "nan"),  # 200 columns: 7 column groups a chain
    ("chain", 60_000, (2, 1, 1), "nan"),  # one chain of 60,000 (the level kernel's 60,000 barriers)
    ("star", 60_000, (2, 1, 1), "nan"),  # 59,999 chains of one vertex under one root
    ("spine", 60_000, (2, 1, 1), "nan"),  # the measured DAG's shape at the main path's C = 4
    ("spine", 60_000, (16, 8, 8), "nan"),  # ... at run_many's C = 32
    ("spine", 60_000, (100, 50, 50), "nan"),  # ... at C = 200
    ("random", 200_000, (1, 1, 1), "nan"),  # ~100,000 chains: far more than resident warps
    # -0.0 in 30 % of the entries of every column, as the CPU tests' data:
    # the roots keep it, and the max columns walk it sign-flipped
    ("chain", 5000, (1, 1, 1), "negzero"),
    ("random", 20_000, (4, 2, 3), "negzero"),
    ("spine", 60_000, (2, 1, 1), "negzero"),
    ("spine", 60_000, (16, 8, 8), "negzero"),
])
def test_inherit_scan_kernel_matches_plain(cuda, monkeypatch, kind, n, monoids, data):
    """The chain-walk kernel against its plain level loop on the card:
    bitwise (as int32 bit patterns, NaN aside) on normal floats with NaN in
    the min/max columns or with -0.0, and across launches."""
    from repro_torch.kernels.inherit_scan import inherit_scan as scan_mod
    from repro_torch.kernels.inherit_scan.ops import forest_layout

    rng = np.random.default_rng(n)
    pid, level = _scan_forest(kind, n, rng)
    forest = forest_layout(pid, level).map(lambda a: torch.from_numpy(a).to(cuda))
    c = sum(monoids)
    x = rng.normal(size=(n, c)).astype(np.float32)
    if data == "negzero":
        x[rng.random((n, c)) < 0.3] = -0.0
    elif c > monoids[0]:  # NaN in the min/max columns
        x[rng.integers(0, n, 50), monoids[0] + rng.integers(0, c - monoids[0], 50)] = np.nan
    x = torch.from_numpy(x).to(cuda)
    want = scan_mod.inherit_scan_plain(x, forest.pid, forest.order, forest.level_ptr,
                                       max_level=forest.max_level, monoids=monoids)
    monkeypatch.setattr(scan_mod, "inherit_scan_plain", _fail)
    before = scan_mod.inherit_scan.launches
    got = scan_mod.inherit_scan(x, forest, monoids=monoids)
    again = scan_mod.inherit_scan(x, forest, monoids=monoids)
    torch.cuda.synchronize()
    assert scan_mod.inherit_scan.launches == before + 2
    if data == "negzero":
        assert bool((torch.signbit(want) & (want == 0)).any())
    _assert_same_bits(got, want)
    _assert_same_bits(again, want)


def test_inherit_scan_on_the_card_needs_the_chain_layout(cuda, monkeypatch):
    """The card reads the chain layout and nothing else: one left on the
    CPU raises, with no route to the plain loop."""
    from repro_torch.kernels.inherit_scan import inherit_scan as scan_mod
    from repro_torch.kernels.inherit_scan.ops import forest_layout

    pid, level = _scan_forest("random", 100, np.random.default_rng(0))
    host = forest_layout(pid, level).map(torch.from_numpy)
    forest = host._replace(chains=host.map(lambda t: t.to(cuda)).chains)
    x = torch.zeros((100, 2), device=cuda)
    monkeypatch.setattr(scan_mod, "inherit_scan_plain", _fail)
    scan_mod.inherit_scan(x, forest, monoids=(2, 0, 0))  # the level layout stays unread
    with pytest.raises(ValueError, match="expected cuda"):
        scan_mod.inherit_scan(x, host, monoids=(2, 0, 0))


def test_topological_session_on_card_matches_host_index(cuda):
    """A topological Session at n = 5,000 on the card: torch-iindex, one K1
    and one scan launch per run() and per run_many(), every aggregate bit
    for bit the host I-Index's, before and after a batch of updates."""
    from repro_torch.core.api import QuerySpec, Session
    from repro_torch.core.updates import UpdateBatch
    from repro_torch.core.windows import TopologicalWindow
    from repro_torch.graphs.generators import random_dag, with_random_attrs
    from repro_torch.kernels.inherit_scan.inherit_scan import inherit_scan
    from repro_torch.kernels.segment_reduce.segment_reduce import segment_sum_tiled

    aggs = ("sum", "count", "avg", "min", "max")
    g = with_random_attrs(random_dag(5000, 10.0, seed=1, locality=200), seed=2)
    sess = Session(g, [QuerySpec(TopologicalWindow(), a) for a in aggs], torch_device=cuda)
    assert [grp.engine for grp in sess.compiled.groups] == ["torch-iindex"]
    (state,) = sess._states.values()

    def check(res, vals):
        for a, r in zip(aggs, res):
            want = state.index.query(vals, a)
            if a == "avg":
                s, c = (state.index.query(vals, x).astype(np.float32) for x in ("sum", "count"))
                want = s / np.maximum(c, np.float32(1e-30))
            assert np.array_equal(r.astype(want.dtype), want), a

    vb = np.random.default_rng(3).integers(0, 100, (8, g.n)).astype(np.float64)
    for step in range(2):
        k1, scans = segment_sum_tiled.launches, inherit_scan.launches
        check(sess.run(), sess.graph.attrs["val"])
        many = sess.run_many(vb)
        assert segment_sum_tiled.launches == k1 + 2 and inherit_scan.launches == scans + 2
        for b in (0, 7):
            check([m[b] for m in many], vb[b])
        order = sess.graph.topological_order()
        heads = order[-20:]
        srcs = order[:20]
        ok = ~sess.graph.contains_edges(srcs, heads)
        sess.update(UpdateBatch.inserts(srcs[ok], heads[ok]))

# ---------------------------------------------------------------------- #
#  The serving tier: a flusher thread serves while another thread updates
# ---------------------------------------------------------------------- #
KHOP_AGGS = ("sum", "count", "avg", "min", "max")


def khop_batch(g, rng, ins=6, dels=3):
    """``ins`` random inserts and ``dels`` deletes of existing edges, as
    (src, dst, op) arrays either package's ``UpdateBatch`` takes."""
    e = rng.choice(g.n_edges, dels, replace=False)
    return (np.concatenate([rng.integers(0, g.n, ins), g.src[e]]).astype(np.int32),
            np.concatenate([rng.integers(0, g.n, ins), g.dst[e]]).astype(np.int32),
            np.concatenate([np.ones(ins, np.int8), -np.ones(dels, np.int8)]))


def concurrent_service_check(dev, n=600, batches=5, seed=21):
    """An ``AsyncWindowService`` whose flusher thread serves point and
    explicit-values reads from a client thread while the calling thread
    applies ``batches`` updates (each after the client has submitted 12
    more tickets); returns (tickets, errors, versions served, session).
    Every ticket must be bitwise its version's expectation, from the host
    index of that version (immutable, kept per version)."""
    import threading
    import time

    import repro_torch.core.api as api
    import repro_torch.serve.window_service as ws
    from repro_torch.core import updates
    from repro_torch.graphs import generators as gen

    g = gen.with_random_attrs(gen.erdos_renyi(n, 4.0, seed=seed), seed=seed + 1)
    sess = api.Session(g, [api.QuerySpec(api.KHopWindow(2), a) for a in KHOP_AGGS],
                       plan_headroom=1.0, torch_device=dev)
    (state,) = sess._states.values()
    indices = {0: (state.index, sess.graph)}
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 100, (4, n)).astype(np.float64)
    tickets, stop = [], threading.Event()

    def client():
        crng = np.random.default_rng(seed + 7)
        while not stop.is_set():
            si = int(crng.integers(len(KHOP_AGGS)))
            v = int(crng.integers(n))
            j = int(crng.integers(len(vals) + 1))
            tickets.append(svc.submit(si, vertex=v, values=vals[j] if j < len(vals) else None,
                                      request_class="point"))
            time.sleep(0.0005)

    def wait_for(count):
        deadline = time.monotonic() + 120
        while len(tickets) < count:
            assert th.is_alive() and time.monotonic() < deadline, "the client stopped"
            time.sleep(0.001)

    with ws.AsyncWindowService(sess, bucket=8, max_pending=64) as svc:
        th = threading.Thread(target=client, daemon=True)
        th.start()
        try:
            for i in range(batches):
                wait_for(12 * (i + 1))
                svc.update(updates.UpdateBatch(*khop_batch(sess.graph, rng)))
                indices[sess.version] = (state.index, sess.graph)
            wait_for(12 * (batches + 1))
        finally:
            stop.set()
            th.join(timeout=60)
    expect = {}

    def expected(version, values):
        key = (version, None if values is None else values.tobytes())
        if key not in expect:
            index, graph = indices[version]
            v = graph.attrs["val"] if values is None else values.astype(np.float64)
            out = {a: index.query(v, a).astype(np.float32) for a in ("sum", "count", "min", "max")}
            out["avg"] = out["sum"] / np.maximum(out["count"], np.float32(1e-30))
            expect[key] = out
        return expect[key]

    errors = []
    for t in tickets:
        res = t.get(timeout=30)
        want = expected(t.version, t.values)[KHOP_AGGS[t.spec_index]][t.vertex]
        if np.float32(res).tobytes() != want.tobytes():
            errors.append((t.rid, t.version, t.spec_index, t.vertex, res, want))
    return len(tickets), errors, {t.version for t in tickets}, sess


def test_async_service_on_card_serves_bitwise_while_another_thread_updates(cuda):
    """The flusher launches K1 on the card while the main thread patches
    plans (copy-on-write while the flusher's view holds one): every ticket
    bitwise its version's host-index expectation."""
    from repro_torch.kernels.segment_reduce.segment_reduce import segment_sum_tiled

    before = segment_sum_tiled.launches
    checked, errors, versions, sess = concurrent_service_check(cuda, n=3000)
    assert checked >= 64 and errors == []
    assert len(versions) >= 2 and sess.plan_clones >= 1
    assert segment_sum_tiled.launches > before


# ---------------------------------------------------------------------- #
#  The cluster tier and ANALYZE on the card
# ---------------------------------------------------------------------- #
def test_replica_set_on_card_serves_bitwise(cuda, tmp_path):
    """A two-replica cluster on the card: every follower's update() runs
    the affected-owner BFS on K2, routed reads run K1, and every routed
    read equals the host index of its pinned version; a killed replica's
    tickets fail over and its checkpoint rejoin equals the writer."""
    from repro_torch.core import api
    from repro_torch.core import updates
    from repro_torch.graphs import generators as gen
    from repro_torch.kernels.bitset_expand.bitset_expand import bitset_expand_tiled
    from repro_torch.kernels.segment_reduce.segment_reduce import segment_sum_tiled
    from repro_torch.obs.audit import graph_crc
    from repro_torch.serve import ReplicaFailedError, ReplicaSet

    g = gen.with_random_attrs(gen.erdos_renyi(3000, 4.0, seed=31), seed=32)
    specs = [api.QuerySpec(api.KHopWindow(2), a) for a in KHOP_AGGS]
    rs = ReplicaSet(g, specs, tmp_path / "c", n_replicas=2, rotate_records=2,
                    checkpoint_every=2, use_device_bfs=True, torch_device=cuda)
    versions = {0: rs.writer.session.graph}
    rng = np.random.default_rng(33)
    k1, k2 = segment_sum_tiled.launches, bitset_expand_tiled.launches
    tickets = []
    for i in range(4):
        rs.update(updates.UpdateBatch(*khop_batch(rs.writer.session.graph, rng)))
        versions[rs.version] = rs.writer.session.graph
        rs.sync()
        if i == 1:
            doomed = rs.router.submit(0, vertex=1, target="r1")
            assert rs.kill("r1") == 1 and doomed.failed
            with pytest.raises(ReplicaFailedError):
                doomed.get(timeout=1)
        tickets += [rs.router.submit(si, vertex=int(v)) for si in range(len(specs))
                    for v in rng.integers(0, g.n, 3)]
        rs.router.flush()
    assert bitset_expand_tiled.launches - k2 >= 2 * 4 + 2  # writer + replicas, every update
    assert segment_sum_tiled.launches > k1
    oracle = {}
    for t in tickets:
        if t.version not in oracle:
            idx = api.Session(versions[t.version], specs, torch_device="cpu")
            oracle[t.version] = idx.run()
        assert np.float32(t.get(timeout=30)).tobytes() == \
            oracle[t.version][t.spec_index][t.vertex].tobytes()
    rep = rs.rejoin("r1")
    rs.sync()
    assert rep.restored_from_version >= 2 and rep.divergence is None
    for x, y in zip(rep.session.run(), rs.writer.session.run()):
        assert x.tobytes() == y.tobytes()
    assert graph_crc(rep.session.graph) == graph_crc(rs.writer.session.graph)
    rs.close()


def test_analyze_on_card_launches_as_run(cuda):
    """ANALYZE makes run()'s launches: 2 K1 per k-hop term, 1 K1 and 1
    scan per topological term; results bitwise run()'s; no new plan
    signature."""
    from repro_torch.core import api
    from repro_torch.graphs import generators as gen
    from repro_torch.kernels.inherit_scan.inherit_scan import inherit_scan
    from repro_torch.kernels.segment_reduce.segment_reduce import segment_sum_tiled

    g = gen.with_random_attrs(gen.barabasi_albert(400, 2, seed=7), seed=2)
    khop = api.Session(g, [api.QuerySpec(api.KHopWindow(2), a) for a in KHOP_AGGS],
                       torch_device=cuda)
    dag = gen.with_random_attrs(gen.random_dag(5000, 10.0, seed=1, locality=200), seed=2)
    topo = api.Session(dag, [api.QuerySpec(api.TopologicalWindow(), a)
                             for a in ("sum", "count", "min", "max")], torch_device=cuda)
    for sess, k1_per, scans_per, phases in (
            (khop, 2, 0, {"host_prep", "pass1_reduce", "pass2_reduce", "finalize"}),
            (topo, 1, 1, {"host_prep", "wd_reduce", "inherit", "finalize"})):
        want = sess.run()
        c0 = api.recompile_count()
        k1, scans = segment_sum_tiled.launches, inherit_scan.launches
        rep = sess.analyze()
        assert segment_sum_tiled.launches - k1 == k1_per
        assert inherit_scan.launches - scans == scans_per
        assert api.recompile_count() == c0
        assert {p["phase"] for p in rep.phases} == phases
        for (gi, ai), w in zip(sess.compiled.spec_slots, want):
            got = rep.results[gi][sess.compiled.groups[gi].aggs[ai]]
            assert got.dtype == w.dtype and got.tobytes() == w.tobytes()


# ---------------------------------------------------------------------- #
#  The sharded runtime on the card (its ranks: tests/test_torch_sharded.py)
# ---------------------------------------------------------------------- #
def test_sharded_session_nccl_world1_bitwise_single_host(cuda, tmp_path):
    """World 1 over NCCL in this process: a 12-batch stream bitwise the
    single-host session on the card, 2 K1 launches per ``run()`` and per
    ``run_many()`` (one a pass), nothing scattered or index-added."""
    import torch.distributed as dist

    import test_torch_sharded as ts

    mesh = ts._init(0, 1, str(tmp_path / "store"), backend="nccl")
    try:
        ss, hs = ts._stream_pair(mesh, torch_device=cuda, tile=128)
        assert ss.compiled.groups[0].engine == "torch-sharded"
        ts._check_stream(ss, hs, np.random.default_rng(13))
        assert ts._k1_launches_per_call(ss.run) == (2, [])
        vb = np.random.default_rng(1).integers(0, 100, (8, ss.graph.n)).astype(np.float64)
        assert ts._k1_launches_per_call(lambda: ss.run_many(vb)) == (2, [])
        ts._check_nan(ss, hs, shard=0)
    finally:
        dist.destroy_process_group()


def test_sharded_session_gloo_world2_on_one_card(cuda, tmp_path):
    """World 2 over gloo, both ranks on ``cuda:0``: each rank's stream
    bitwise its single-host session, 2 K1 launches a rank per ``run()``,
    a NaN that only rank 1 reduces kept; both ranks hold one digest."""
    import test_torch_sharded as ts

    outs = ts._spawn("stream_cuda", 2, tmp_path, SHARDED_BACKEND="gloo")
    assert len({(p.parent / f"{p.name}.txt").read_text() for p in outs}) == 1


def test_sharded_session_nccl_world2(cuda, tmp_path):
    """World 2 over NCCL, one rank a card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("NCCL at world size 2 needs two cards (it refuses two ranks on one)")
    import test_torch_sharded as ts

    outs = ts._spawn("stream_cuda", 2, tmp_path, SHARDED_BACKEND="nccl")
    assert len({(p.parent / f"{p.name}.txt").read_text() for p in outs}) == 1


# ---------------------------------------------------------------------- #
#  Serving over a sharded session on the card (tests/test_torch_sharded_service.py)
# ---------------------------------------------------------------------- #
def test_sharded_service_nccl_world1_bitwise_single_host(cuda, tmp_path):
    """World 1 over NCCL in this process: the reference's service scenario
    (one coalesced launch for the 3-ticket flush, cached point reads
    across updates) bitwise the same scenario on a single-host session on
    the card."""
    import torch.distributed as dist

    import test_torch_sharded as ts
    import test_torch_sharded_service as tss

    mesh = ts._init(0, 1, str(tmp_path / "store"), backend="nccl")
    try:
        sess, _, rng = tss._service_pair(mesh, cuda)
        got, _ = tss._service_scenario(sess, rng)
    finally:
        dist.destroy_process_group()
    host, _, hrng = tss._service_pair(None, cuda)
    want, _ = tss._service_scenario(host, hrng)
    assert [g.tobytes() for g in got] == [w.tobytes() for w in want]


def test_sharded_service_gloo_world2_on_one_card(cuda, tmp_path):
    """World 2 over gloo, both ranks on ``cuda:0``: rank 0 leads the
    service and the async service, rank 1 follows; no hang, every ticket
    of rank 0 bitwise the single-host scenario on the card."""
    import pathlib

    import test_torch_sharded_service as tss

    outs, _ = tss._spawn("service", 2, tmp_path, SERVICE_DEVICE="cuda")
    saved = np.load(f"{outs[0]}.npz")
    got = [saved[f"arr_{i}"] for i in range(len(saved.files))]
    host, _, hrng = tss._service_pair(None, cuda)
    want, _ = tss._service_scenario(host, hrng)
    assert [g.tobytes() for g in got] == [w.tobytes() for w in want]
    assert int(pathlib.Path(f"{outs[0]}.txt").read_text()) == tss.ASYNC_TICKETS


# ---------------------------------------------------------------------- #
#  The GNN family and khop_aggregate on K1 (tests/test_torch_gnn.py)
# ---------------------------------------------------------------------- #
GNN_K1_PER_LAYER = {"gcn": 1, "sage": 1, "gat": 3, "meshgraphnet": 1}


@pytest.mark.parametrize("mod", ["gcn_cora", "gat_cora", "graphsage_reddit", "meshgraphnet"])
def test_gnn_smoke_forward_on_card_matches_cpu(cuda, mod):
    """Each SMOKE GNN forward on the card: K1 launches as stated (GCN and
    SAGE 1 a layer, GAT 3, MGN 1 a step), two forwards bitwise equal, the
    output within rtol = 1e-4, atol = 1e-5 of the same forward on the CPU
    (K1's plain version; the orders of the adds differ)."""
    import importlib

    from repro_torch.kernels.segment_reduce.segment_reduce import segment_sum_tiled
    from repro_torch.models import gnn

    cfg = importlib.import_module(f"repro_torch.configs.{mod}").SMOKE
    rng = np.random.default_rng(3)
    n, e = 300, 1500
    dst = np.concatenate([np.sort(rng.integers(0, n, e)), np.full(36, n)]).astype(np.int32)
    src = np.concatenate([rng.integers(0, n, e), np.full(36, n)]).astype(np.int32)
    w = rng.random(src.size).astype(np.float32)
    x = rng.standard_normal((n, cfg.d_in)).astype(np.float32)
    ef = rng.standard_normal((src.size, 3)).astype(np.float32)
    init = {"gcn": gnn.gcn_init, "sage": gnn.sage_init, "gat": gnn.gat_init,
            "meshgraphnet": gnn.mgn_init}[cfg.kind]
    params = init(torch.Generator().manual_seed(0), cfg)

    def run(dev):
        p = _to(params, dev)
        plan = gnn.edge_plan(src, dst, n, torch_device=dev)
        xs, efs = torch.from_numpy(x).to(dev), torch.from_numpy(ef).to(dev)
        s_t, d_t = torch.from_numpy(src).to(dev), torch.from_numpy(dst).to(dev)
        if cfg.kind == "gcn":
            return gnn.gcn_forward(p, xs, s_t, d_t, torch.from_numpy(w).to(dev), n, cfg, plan=plan)
        if cfg.kind == "sage":
            return gnn.sage_forward(p, xs, s_t, d_t, n, cfg, plan=plan)
        if cfg.kind == "gat":
            return gnn.gat_forward(p, xs, s_t, d_t, n, cfg, plan=plan)
        return gnn.mgn_forward(p, xs, efs, s_t, d_t, n, cfg, plan=plan)

    before = segment_sum_tiled.launches
    got = run(cuda)
    torch.cuda.synchronize()
    assert segment_sum_tiled.launches - before == GNN_K1_PER_LAYER[cfg.kind] * cfg.n_layers
    assert torch.equal(got, run(cuda))
    torch.testing.assert_close(got.cpu(), run(torch.device("cpu")), rtol=1e-4, atol=1e-5)


# K1 launches of a training step (two layers; MeshGraphNet per processor
# step): forward, and backward for each layer whose input needs a gradient
# (MeshGraphNet's: its two gathers' transposes and the recomputed forward)
GNN_K1_BWD = {"gcn": 1, "sage": 1, "gat": 4, "meshgraphnet": 3}


def _plain_k1(tp, values, monoids):
    from repro_torch.kernels.segment_reduce.segment_reduce import segment_reduce_plain

    return segment_reduce_plain(values.float(), tp.gather_padded, tp.seg_tiles,
                                monoids=tuple(monoids), num_out_tiles=tp.num_out_tiles,
                                ts=tp.ts)[: tp.num_segments]


@pytest.mark.parametrize("mod", ["gcn_cora", "gat_cora", "graphsage_reddit", "meshgraphnet"])
def test_gnn_k1_backward_on_card_matches_plain_autograd(cuda, mod, monkeypatch):
    """A SMOKE GNN's loss and gradients on the card, where every sum of the
    backward is a K1 launch over the source-sorted layout: K1 launches in
    the forward and the backward as stated, two backward passes bitwise
    equal, and each gradient element within 1e-4 * (|plain| + rms(plain))
    of the plain route (K1's plain version under PyTorch's autograd,
    ``index_select`` and ``index_add_``: another order of the adds)."""
    import importlib

    from repro_torch.kernels.segment_reduce.segment_reduce import segment_sum_tiled
    from repro_torch.launch import steps
    from repro_torch.models import gnn
    from repro_torch.tree import leaves, unflatten

    cfg = importlib.import_module(f"repro_torch.configs.{mod}").SMOKE
    rng = np.random.default_rng(5)
    n, e, pad = 300, 1500, 36
    dst = np.concatenate([np.sort(rng.integers(0, n - 5, e)), np.full(pad, n)])
    src = np.concatenate([rng.integers(0, n, e), np.full(pad, n)])
    batch = {"feats": rng.standard_normal((n, cfg.d_in)), "edge_src": src, "edge_dst": dst,
             "edge_w": rng.random(e + pad), "edge_feats": rng.standard_normal((e + pad, 3)),
             "targets": rng.standard_normal((n, cfg.d_out)),
             "labels": rng.integers(0, cfg.d_out, n),
             "label_mask": (rng.random(n) < 0.5)}
    batch = {k: torch.from_numpy(v.astype(np.int32 if v.dtype.kind in "iu" else np.float32))
             .to(cuda) for k, v in batch.items()}
    init = {"gcn": gnn.gcn_init, "sage": gnn.sage_init, "gat": gnn.gat_init,
            "meshgraphnet": gnn.mgn_init}[cfg.kind]
    params = _to(init(torch.Generator().manual_seed(1), cfg), cuda)
    plan = gnn.edge_plan(src.astype(np.int32), dst.astype(np.int32), n, torch_device=cuda)
    live = [p.detach().requires_grad_() for p in leaves(params)]
    before = segment_sum_tiled.launches
    loss = steps.gnn_loss(unflatten(params, live), batch, cfg, n, plan=plan)
    fwd = segment_sum_tiled.launches - before
    grads = torch.autograd.grad(loss, live)
    torch.cuda.synchronize()
    bwd = segment_sum_tiled.launches - before - fwd
    bwd_layers = cfg.n_layers - 1 if cfg.kind in ("gcn", "sage") else cfg.n_layers
    assert (fwd, bwd) == (GNN_K1_PER_LAYER[cfg.kind] * cfg.n_layers,
                          GNN_K1_BWD[cfg.kind] * bwd_layers)
    again = steps.gnn_value_and_grad(params, batch, cfg, n, plan)
    assert torch.equal(loss.detach(), again[0])
    for x, y in zip(grads, leaves(again[1])):
        assert torch.equal(x, y)
    monkeypatch.setattr(gnn, "_record", lambda *ts: False)
    monkeypatch.setattr(gnn, "segment_reduce_multi", _plain_k1)
    p_loss, p_grads = steps.gnn_value_and_grad(params, batch, cfg, n, plan)
    torch.testing.assert_close(loss.detach(), p_loss, rtol=1e-5, atol=0)
    for x, y in zip(grads, leaves(p_grads)):
        rms = y.pow(2).mean().sqrt()
        assert bool(((x - y).abs() <= 1e-4 * (y.abs() + rms)).all())


def test_gwq_step_on_card_bitwise_numpy(cuda):
    """``build_gwq_step`` on one card: two K1 launches, bitwise NumPy's
    int64 sums of the two passes on integer values."""
    from repro_torch.kernels.segment_reduce.segment_reduce import segment_sum_tiled
    from repro_torch.launch import steps

    rng = np.random.default_rng(2)
    n, nb, m, l = 5000, 2000, 40_000, 9000
    p1s, p2s = np.sort(rng.integers(0, nb, m)), np.sort(rng.integers(0, n, l))
    p1g, p2g = rng.integers(0, n, m), rng.integers(0, nb, l)
    vals = rng.integers(0, 100, n)
    pad = (-m) % 128
    rows = (np.concatenate([p1g, np.zeros(pad)]).astype(np.int32),
            np.concatenate([p1s, np.full(pad, -1)]).astype(np.int32),
            p2g.astype(np.int32), p2s.astype(np.int32), vals.astype(np.float32))
    built = steps.build_gwq_step(dict(n=n, nb=nb, m=m, l=l), None, torch_device=cuda)
    before = segment_sum_tiled.launches
    got = built.run(*rows)
    torch.cuda.synchronize()
    assert segment_sum_tiled.launches - before == 2
    t = np.bincount(p1s, weights=vals[p1g], minlength=nb)
    want = np.bincount(p2s, weights=t[p2g], minlength=n)
    assert np.array_equal(got.cpu().numpy().astype(np.float64), want)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


@pytest.mark.parametrize("agg", ["sum", "min", "max", "count"])
def test_khop_features_on_card_bitwise_cpu(cuda, agg):
    """``query_dbindex`` over integer ``[n, D]`` features on the card: 2 K1
    launches for sum (1 for count, which reads no values), bitwise the
    CPU's plain version; ``khop_aggregate`` is the sum."""
    from repro_torch.core.dbindex import build_dbindex
    from repro_torch.core.engine_torch import plan_from_dbindex, query_dbindex
    from repro_torch.core.windows import KHopWindow
    from repro_torch.graphs.generators import erdos_renyi
    from repro_torch.kernels.segment_reduce.segment_reduce import segment_sum_tiled
    from repro_torch.models import gnn

    idx = build_dbindex(erdos_renyi(5000, 8.0, seed=2), KHopWindow(2), method="emc")
    x = np.random.default_rng(4).integers(0, 100, (5000, 24)).astype(np.float32)
    want = query_dbindex(plan_from_dbindex(idx, torch_device="cpu"), x, agg)
    plan = plan_from_dbindex(idx, torch_device=cuda)
    before = segment_sum_tiled.launches
    got = query_dbindex(plan, torch.from_numpy(x).to(cuda), agg)
    torch.cuda.synchronize()
    if agg == "sum":
        assert segment_sum_tiled.launches - before == 2
        assert torch.equal(gnn.khop_aggregate(plan, torch.from_numpy(x).to(cuda)), got)
    assert torch.equal(got.cpu(), want)


def test_minitron_prefill_on_card_takes_the_sm90_route(cuda):
    """minitron-8b's widths (d 4096, 32 heads over 8 kv heads, head_dim
    128) cut to 2 layers and a 512-token vocabulary: one K3 launch a layer
    on the tensor-core route, logits close to the plain backend's (the
    repo's bf16 tolerance)."""
    import dataclasses

    from repro_torch.configs.minitron_8b import CONFIG
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(CONFIG, n_layers=2, vocab=512, d_ff=1024)
    params = T.init(torch.Generator(device=cuda).manual_seed(0), cfg)
    toks = torch.randint(0, cfg.vocab, (2, 300), device=cuda)
    before = flash_attention.launches_by_route["sm90"]
    _, logits = T.prefill(params, toks, cfg)
    assert flash_attention.launches_by_route["sm90"] == before + cfg.n_layers
    _, plain = T.prefill(params, toks, cfg, attn_backend="flash_torch")
    torch.testing.assert_close(logits, plain, atol=0.06, rtol=0.05)


@pytest.mark.parametrize("mod", ["qwen2_moe_a2p7b", "grok1_314b"])
def test_moe_smoke_prefill_on_card_matches_cpu(cuda, monkeypatch, mod):
    """The MoE SMOKE prefill on the card: one K3 launch a layer, bitwise
    across two calls.  On the CPU, the same prefill routing on its own may
    take other experts only at near ties (``moe.route_flips``), and one
    that takes the card's experts, with K3's plain version (float32 scores,
    p rounded to bf16 before the PV product, as the kernel rounds it) in
    the attention's place, is within the repo's bf16 tolerance of the
    card's logits and cache everywhere.  The CPU's own attention at S =
    300 is ``mha_ref``, whose scores and softmax round to bf16: it parts
    from K3 at layer 0, and through the residual it can move layer 1's
    cache past the tolerance (``test_moe_smoke_prefill_oracle_drift``)."""
    import importlib

    from repro_torch.kernels.flash_attention.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_torch
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T

    cfg = importlib.import_module(f"repro_torch.configs.{mod}").SMOKE
    params = M.init(torch.Generator(device=cuda).manual_seed(0), cfg)
    toks = torch.randint(0, cfg.vocab, (2, 300), device=cuda)
    rec, follow, route = [], [], M._route

    def recorded(xt, router, c):
        if follow:
            return route(xt, router, c, follow.pop(0).view(*xt.shape[:2], c.top_k))
        out = route(xt, router, c)
        rec.append(((xt @ router).float().reshape(-1, router.shape[1]).cpu(),
                    out[0].reshape(-1, c.top_k).cpu()))
        return out

    monkeypatch.setattr(M, "_route", recorded)
    before = flash_attention.launches
    kv, logits = M.prefill(params, toks, cfg)
    assert flash_attention.launches == before + cfg.n_layers
    kv2, logits2 = M.prefill(params, toks, cfg)
    torch.cuda.synchronize()
    assert torch.equal(logits, logits2)
    assert all(torch.equal(kv[k], kv2[k]) for k in kv)
    card = rec[:cfg.n_layers]
    del rec[:]
    host = {k: ([{n: t.cpu() for n, t in lp.items()} for lp in v] if k == "layers"
                else v.cpu()) for k, v in params.items()}
    M.prefill(host, toks.cpu(), cfg)
    flips = M.route_flips(*(torch.stack([r[i] for r in rec]) for i in (0, 1)),
                          *(torch.stack([r[i] for r in card]) for i in (0, 1)), 2)
    assert all(ratio <= 1 for *_, ratio in flips["first_flips"]), flips["first_flips"]
    follow.extend(experts for _, experts in card)
    with monkeypatch.context() as m:
        m.setattr(T, "attention", lambda q, k, v, **_: flash_torch(
            q, k, v, causal=True, p_dtype=v.dtype))
        kv_h, logits_h = M.prefill(host, toks.cpu(), cfg)
    assert not follow
    torch.testing.assert_close(logits.cpu(), logits_h, atol=0.06, rtol=0.05)
    for k in kv:
        torch.testing.assert_close(kv[k].cpu(), kv_h[k], atol=0.06, rtol=0.05)


@pytest.mark.cuda
def test_moe_smoke_prefill_oracle_drift(cuda, monkeypatch):
    """Where the qwen2-moe SMOKE prefill on the card parts from the CPU's,
    over ``DRAWS`` token draws (both runs take the card's experts): the
    largest |card - cpu| / (0.06 + 0.05 |cpu|) of each layer's k and v and
    of the logits, with the CPU's attention as ``mha_ref`` (its own route
    at S = 300: scores and softmax in bf16) and as K3's plain version
    (float32 scores, p rounded to bf16), and layer 0's attention output
    against both on the same q, k, v.  K3's rounding must keep every draw
    within the tolerance; the printed line records both oracles."""
    import json

    from repro_torch.configs.qwen2_moe_a2p7b import SMOKE as cfg
    from repro_torch.kernels.flash_attention.ref import flash_torch, mha_ref
    from repro_torch.models import layers as L
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T

    draws = 100
    params = M.init(torch.Generator(device=cuda).manual_seed(0), cfg)
    host = {k: ([{n: t.cpu() for n, t in lp.items()} for lp in v] if k == "layers"
                else v.cpu()) for k, v in params.items()}
    route = M._route

    def ratio(a, b):
        return float(((a.float().cpu() - b.float()).abs() / (0.06 + 0.05 * b.float().abs()))
                     .max())

    def prefill(p, toks, follow=None, rec=None):
        def routed(xt, router, c):
            if follow:
                return route(xt, router, c, follow.pop(0).to(xt.device).view(
                    *xt.shape[:2], c.top_k))
            out = route(xt, router, c)
            rec.append(out[0].reshape(-1, c.top_k).cpu())
            return out

        with monkeypatch.context() as m:
            m.setattr(M, "_route", routed)
            return M.prefill(p, toks, cfg)

    plain = lambda q, k, v, **_: flash_torch(q, k, v, causal=True, p_dtype=v.dtype)  # noqa: E731
    worst = {"mha_ref": {}, "k3_plain": {}}
    misses = {"mha_ref": 0, "k3_plain": 0}
    attn0 = {"mha_ref": 0.0, "k3_plain": 0.0}
    for _ in range(draws):
        toks = torch.randint(0, cfg.vocab, (2, 300), device=cuda)
        rec = []
        kv, logits = prefill(params, toks, rec=rec)
        for name in worst:
            with monkeypatch.context() as m:
                if name == "k3_plain":
                    m.setattr(T, "attention", plain)
                kv_h, logits_h = prefill(host, toks.cpu(), follow=list(rec))
            r = {f"{k}{layer}": ratio(kv[k][layer], kv_h[k][layer])
                 for k in kv for layer in range(cfg.n_layers)}
            r["logits"] = ratio(logits, logits_h)
            misses[name] += max(r.values()) > 1
            worst[name] = {k: max(v, worst[name].get(k, 0.0)) for k, v in r.items()}
        x0 = params["embed"][toks.long()].to(cfg.cdtype)
        cos, sin = L.rope_freqs(cfg.head_dim, 300, cfg.rope_theta, cuda)
        q, k, v = T._qkv(params["layers"][0], x0, cfg, None, cos, sin)
        o = T.attention(q, k, v, causal=True).float().cpu()
        qc, kc, vc = q.cpu(), k.cpu(), v.cpu()
        for name, want in (("mha_ref", mha_ref(qc, kc, vc, causal=True)),
                           ("k3_plain", plain(qc, kc, vc))):
            attn0[name] = max(attn0[name], float((o - want.float()).abs().max()))
    print(json.dumps({"draws": draws, "misses": misses, "worst": worst,
                      "layer0_attention_max_abs": attn0}))
    assert misses["k3_plain"] == 0, worst["k3_plain"]


# ------------------------- training on the card ------------------------- #
def _rel_l2(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30))


def _f32_close(got, want):
    """Each element within 1e-4 (|plain| + rms(plain))."""
    rms = want.float().square().mean().sqrt()
    return bool(((got.float() - want.float()).abs()
                 <= 1e-4 * (want.float().abs() + rms)).all())


# (B, Hq, Hkv, S, D, causal): the head sizes and group sizes K3 takes,
# ragged S around the 64-row tiles, and non-causal
K3_BWD_CASES = [(2, 4, 2, 256, 64, True), (1, 8, 8, 130, 32, True), (2, 2, 1, 77, 16, True),
                (1, 4, 2, 1000, 128, True), (3, 6, 3, 1, 64, True), (1, 4, 4, 65, 128, True),
                (1, 16, 8, 2048, 64, True), (1, 16, 16, 513, 128, True),
                (2, 4, 2, 333, 64, False), (1, 8, 1, 200, 32, False)]


# the tensor-core backward's edges (bf16, D 64 and 128): groups of 1, 2
# and 8 query heads a kv head, S around the 64-row query tiles, the 64-key
# tiles of the dQ pass and the 128-key tiles of the dK/dV pass, and one
# long ragged S; then non-causal
K3_BWD_SM90_CASES = ([(1, 2 * g, 2, s, d, True) for d in (64, 128) for g in (1, 2, 8)
                      for s in (1, 63, 64, 65, 127, 128, 129, 4097)]
                     + [(2, 4, 2, s, d, False) for d in (64, 128) for s in (65, 1000)])


def _k3_bwd_check(cuda, monkeypatch, dtype, b, hq, hkv, s, d, causal):
    """K3's backward on the card against autograd through flash_torch on
    the same q, k, v, o and dO: float32 within 1e-4 (|plain| + rms(plain))
    in every element; bf16 a relative L2 error of at most 2e-2 a tensor;
    bitwise across two launches; one count a call, on the route
    ``bwd_route`` names.  On the sm90 route the simt library may not be
    reached at all."""
    from repro_torch.kernels.flash_attention import flash_attention as fa

    g = torch.Generator(device=cuda).manual_seed(s + d + hq)
    q, k, v = (torch.randn((b, h, s, d), generator=g, device=cuda).to(dtype)
               for h in (hq, hkv, hkv))
    do = torch.randn((b, hq, s, d), generator=g, device=cuda).to(dtype)
    o = fa.flash_attention(q, k, v, causal=causal)
    want = fa.flash_attention_bwd_plain(q, k, v, do, causal=causal)
    path = fa.bwd_route(dtype, d)
    assert path == ("sm90" if dtype == torch.bfloat16 and d in (64, 128) else "simt")
    monkeypatch.setattr(fa, "flash_attention_bwd_plain", _fail)
    monkeypatch.setattr(fa, "flash_torch", _fail)
    if path == "sm90":
        lib = fa._bwd_lib
        monkeypatch.setattr(fa, "_bwd_lib", lambda name: _fail() if name == "simt" else lib(name))
    before = fa.flash_attention_bwd.launches
    before_route = dict(fa.flash_attention_bwd.launches_by_route)
    got = fa.flash_attention_bwd(q, k, v, o, do, causal=causal)
    again = fa.flash_attention_bwd(q, k, v, o, do, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd.launches == before + 2
    assert fa.flash_attention_bwd.launches_by_route == {
        **before_route, path: before_route[path] + 2}
    for x, y, w, name in zip(got, again, want, ("dq", "dk", "dv")):
        assert x.dtype == dtype and x.shape == w.shape, name
        assert torch.equal(x, y), name
        assert bool(torch.isfinite(x).all()), name
        if not bool(w.float().abs().max() > 0):
            # S = 1: one key a row, so dq is 0; the kernel's is dp - delta
            # rounded (the two sums of dO . v in another order) times k
            assert float(x.float().abs().max()) <= 1e-5, name
        elif dtype == torch.float32:
            assert _f32_close(x, w), name
        else:
            assert _rel_l2(x, w) <= 2e-2, (name, _rel_l2(x, w))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,hq,hkv,s,d,causal", K3_BWD_CASES)
def test_flash_attention_bwd_kernel_matches_plain(cuda, monkeypatch, dtype, b, hq, hkv, s,
                                                  d, causal):
    _k3_bwd_check(cuda, monkeypatch, dtype, b, hq, hkv, s, d, causal)


@pytest.mark.parametrize("b,hq,hkv,s,d,causal", K3_BWD_SM90_CASES)
def test_flash_attention_bwd_sm90_matches_plain(cuda, monkeypatch, b, hq, hkv, s, d, causal):
    _k3_bwd_check(cuda, monkeypatch, torch.bfloat16, b, hq, hkv, s, d, causal)


def test_attention_training_on_card_takes_both_kernels(cuda, monkeypatch):
    """A loss through ``attention`` on the card: one forward launch, one
    backward call, gradients in q, k and v nonzero and within bf16's bound
    of autograd through the plain version; no plain version reached."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.models import attention as attn_mod

    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn((2, h, 300, 64), generator=g, device=cuda)
               .bfloat16().requires_grad_() for h in (8, 4, 4))
    with torch.enable_grad():
        ref = fa.flash_torch(q, k, v).float().square().sum()
        want = torch.autograd.grad(ref, (q, k, v))
    monkeypatch.setattr(attn_mod, "flash_torch", _fail)
    monkeypatch.setattr(fa, "flash_attention_bwd_plain", _fail)
    fwd, bwd = fa.flash_attention.launches, fa.flash_attention_bwd.launches
    out = attn_mod.attention(q, k, v)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out.float().square().sum(), (q, k, v))
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches, fa.flash_attention_bwd.launches) == (fwd + 1, bwd + 1)
    for x, w in zip(got, want):
        assert float(x.float().abs().sum()) > 0
        assert _rel_l2(x, w) <= 2e-2
    with torch.no_grad():  # serving: the forward alone
        attn_mod.attention(q, k, v)
    assert fa.flash_attention_bwd.launches == bwd + 1


@pytest.mark.parametrize("b,f,k", [(64, 39, 10), (100, 8, 16), (256, 5, 3), (65536, 39, 10)])
def test_fm_interaction_bwd_kernel_matches_plain(cuda, monkeypatch, b, f, k):
    """K4's backward kernel against autograd through the oracle: each
    element within 1e-5 of |g| (sum_f |e| + |e|); bitwise across launches;
    through ``fm_second_order`` in training one forward and one backward
    launch."""
    from repro_torch.kernels.fm_interaction import fm_interaction as fm_mod
    from repro_torch.kernels.fm_interaction.ops import fm_second_order

    gen = torch.Generator(device=cuda).manual_seed(b)
    emb = torch.randn((b, f, k), generator=gen, device=cuda)
    g = torch.randn((b,), generator=gen, device=cuda)
    want = fm_mod.fm_interaction_bwd_plain(emb, g)
    mass = g.abs()[:, None, None] * (emb.abs().sum(1, keepdim=True) + emb.abs())
    monkeypatch.setattr(fm_mod, "fm_interaction_bwd_plain", _fail)
    monkeypatch.setattr(fm_mod, "fm_interaction_plain", _fail)
    before = fm_mod.fm_interaction_bwd.launches
    got = fm_mod.fm_interaction_bwd(emb, g)
    again = fm_mod.fm_interaction_bwd(emb, g)
    torch.cuda.synchronize()
    assert fm_mod.fm_interaction_bwd.launches == before + 2
    assert torch.equal(got, again)
    assert bool(((got - want).abs() <= 1e-5 * mass + 1e-30).all())
    e = emb.clone().requires_grad_()
    fwd = fm_mod.fm_interaction.launches
    (through,) = torch.autograd.grad(fm_second_order(e), e, g)
    assert (fm_mod.fm_interaction.launches, fm_mod.fm_interaction_bwd.launches) == \
        (fwd + 1, before + 3)
    assert torch.equal(through, got)


def test_k1_refuses_a_tracked_input(cuda):
    """K1's wrapper raises on values that autograd would record, instead of
    returning a result with no gradient; untracked, it launches."""
    from repro_torch.kernels.segment_reduce import ops

    rng = np.random.default_rng(0)
    seg = np.sort(rng.integers(0, 30, 200)).astype(np.int32)
    plan = ops.build_tile_plan(rng.integers(0, 50, 200).astype(np.int32), seg, 30,
                               torch_device=cuda)
    vals = torch.randn((50, 2), device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="requires grad"):
        ops.segment_sum(plan, vals)
    with torch.no_grad():
        ops.segment_sum(plan, vals)
    ops.segment_sum(plan, vals.detach())


def test_k2_inputs_are_never_tracked(cuda):
    """K2 reads int32 bitsets, which cannot require grad, so autograd never
    records it: under grad mode it launches and its result has no grad_fn."""
    from repro_torch.kernels.bitset_expand import ops

    es, ed = _k2_edges("er", 300)
    plan = ops.build_expand_plan(es, ed, 300, torch_device=cuda)
    with pytest.raises(RuntimeError):
        torch.zeros(4, dtype=torch.int32, device=cuda).requires_grad_()
    with torch.enable_grad():
        r, m = ops.khop_reach_masked(plan, 300, np.arange(5), 2, 128)
    assert r.grad_fn is None and not r.requires_grad


def test_inherit_scan_refuses_a_tracked_input(cuda):
    from repro_torch.kernels.inherit_scan import inherit_scan as scan_mod
    from repro_torch.kernels.inherit_scan.ops import forest_layout

    pid, level = _scan_forest("random", 100, np.random.default_rng(0))
    forest = forest_layout(pid, level).map(lambda a: torch.from_numpy(a).to(cuda))
    x = torch.randn((100, 2), device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="requires grad"):
        scan_mod.inherit_scan(x, forest, monoids=(2, 0, 0))
    with torch.no_grad():
        scan_mod.inherit_scan(x, forest, monoids=(2, 0, 0))


def test_k3_and_k4_raw_wrappers_refuse_a_tracked_input(cuda):
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention
    from repro_torch.kernels.fm_interaction.fm_interaction import fm_interaction

    q = torch.randn((1, 2, 16, 16), device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="requires grad"):
        flash_attention(q, q, q)
    emb = torch.randn((4, 3, 2), device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="requires grad"):
        fm_interaction(emb)


def _on_cpu(card, host):
    """``host`` (a CPU trainer) starting from ``card``'s initial params (a
    generator on the card draws other numbers than one on the CPU)."""
    from repro_torch.tree import tree_map

    host.params = tree_map(lambda t: t.cpu(), card.params)
    host.opt_state = host.opt.init(host.params)
    return host


def test_smoke_training_on_card_counts_launches_and_resumes(cuda, tmp_path):
    """qwen3 SMOKE at head size 64 (d 384, 6 heads) trains on the card with
    remat and microbatch 2: K3 twice forward (the step, the remat recompute)
    and once backward a layer and microbatch; the losses within 1e-2 of the
    same trainer on the CPU (bf16 in another order); a resume from the
    midpoint checkpoint equal to the uninterrupted run at rtol 1e-6."""
    import dataclasses

    from repro_torch.configs.qwen3_0p6b import SMOKE
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.launch.train import build_trainer

    cfg = dataclasses.replace(SMOKE, d_model=384, n_heads=6, n_kv_heads=3, remat=True)
    kw = dict(batch=2, seq=96, steps=4, microbatch=2, cfg=cfg)
    tr = build_trainer("qwen3-0.6b", ckpt_dir=str(tmp_path / "a"), torch_device=cuda, **kw)
    host = _on_cpu(tr, build_trainer("qwen3-0.6b", torch_device="cpu", **kw))
    fwd, bwd = fa.flash_attention.launches, fa.flash_attention_bwd.launches
    tr.run(4)
    per_step = cfg.n_layers * 2
    assert fa.flash_attention.launches - fwd == 4 * per_step * 2
    assert fa.flash_attention_bwd.launches - bwd == 4 * per_step
    host.run(4)
    np.testing.assert_allclose([h["loss"] for h in tr.history],
                               [h["loss"] for h in host.history], rtol=1e-2)
    again = build_trainer("qwen3-0.6b", ckpt_dir=str(tmp_path / "a"), torch_device=cuda, **kw)
    state, extra, _ = again.ckpt.restore({"params": again.params, "opt": again.opt_state},
                                         step=2)
    again.params, again.opt_state, again.step = state["params"], state["opt"], 2
    again.data.restore(extra["data"])
    again.run(2)
    np.testing.assert_allclose([h["loss"] for h in again.history],
                               [h["loss"] for h in tr.history][2:], rtol=1e-6)


def test_fm_training_on_card_takes_k4_both_ways(cuda):
    from repro_torch.kernels.fm_interaction import fm_interaction as fm_mod
    from repro_torch.launch.train import build_trainer

    tr = build_trainer("fm", batch=4096, steps=3, torch_device=cuda)
    host = _on_cpu(tr, build_trainer("fm", batch=4096, steps=3, torch_device="cpu"))
    fwd, bwd = fm_mod.fm_interaction.launches, fm_mod.fm_interaction_bwd.launches
    tr.run(3)
    assert (fm_mod.fm_interaction.launches - fwd, fm_mod.fm_interaction_bwd.launches - bwd) == (3, 3)
    host.run(3)
    np.testing.assert_allclose([h["loss"] for h in tr.history],
                               [h["loss"] for h in host.history], rtol=1e-5)

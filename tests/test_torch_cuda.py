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


@pytest.mark.parametrize("n,deg,k", [(200, 4.0, 1), (300, 6.0, 2), (3000, 10.0, 2)])
def test_bitset_expand_kernel_matches_plain(cuda, n, deg, k):
    from repro_torch.graphs.generators import erdos_renyi
    from repro_torch.kernels.bitset_expand import ops

    g = erdos_renyi(n, deg, seed=n)
    src = np.concatenate([g.src, g.dst])
    dst = np.concatenate([g.dst, g.src])
    order = np.argsort(dst, kind="stable")
    sources = np.arange(min(n, 4096), dtype=np.int32)
    plans = [ops.build_expand_plan(src[order], dst[order], n, torch_device=dev)
             for dev in ("cpu", cuda)]
    ref, got = (ops.khop_reach(p, n, sources, k) for p in plans)
    assert torch.equal(got.cpu(), ref)

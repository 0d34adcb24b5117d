"""Kernel K2 (bitset BFS hop), port vs reference, on the CPU.

The port's ``khop_reach`` (its plain version here: the tensors lie on the
CPU) is bit-equal to the reference's Pallas ``khop_reach`` in interpret
mode (compared as int32 views of the same words), to the NumPy
``khop_reach_ref`` (the port's copy, itself equal to the reference's) and
to the host ``khop_window_single`` BFS.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.kernels.bitset_expand import ops as r_ops  # noqa: E402
from repro.kernels.bitset_expand.ref import khop_reach_ref as r_khop_reach_ref  # noqa: E402

from repro_torch.core.windows import khop_window_single  # noqa: E402
from repro_torch.graphs.generators import erdos_renyi  # noqa: E402
from repro_torch.kernels.bitset_expand import ops as p_ops  # noqa: E402
from repro_torch.kernels.bitset_expand.ref import khop_reach_ref  # noqa: E402


def _dst_sorted_edges(g):
    src = np.concatenate([g.src, g.dst])
    dst = np.concatenate([g.dst, g.src])
    order = np.argsort(dst, kind="stable")
    return src[order], dst[order]


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

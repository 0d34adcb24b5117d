"""Oracle for packed-bitset frontier expansion (k-hop BFS step).

``out[s] = OR over { reach[src[i]] : dst[i] == s }  |  reach[s]``

The NumPy oracle mirrors :func:`repro_torch.core.windows.khop_reach_bitsets` one
hop at a time (uint32 words here, uint64 on the host path).
"""

from __future__ import annotations

import numpy as np


def bitset_expand_ref(reach, edge_src, edge_dst, n):
    """reach: [n, W] uint32; edges sorted by dst; returns new reach."""
    reach = np.asarray(reach)
    src = np.asarray(edge_src)
    dst = np.asarray(edge_dst)
    out = reach.copy()
    valid = (dst >= 0) & (dst < n)
    src, dst = src[valid], dst[valid]
    if src.size:
        order = np.argsort(dst, kind="stable")
        src, dst = src[order], dst[order]
        starts = np.flatnonzero(np.diff(dst, prepend=-1))
        red = np.bitwise_or.reduceat(reach[src], starts, axis=0)
        uniq = dst[starts]
        out[uniq] |= red
    return out


def khop_reach_ref(reach0, edge_src, edge_dst, n, k):
    r = np.asarray(reach0).copy()
    for _ in range(k):
        r = bitset_expand_ref(r, edge_src, edge_dst, n)
    return r

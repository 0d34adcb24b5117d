"""MinHash signatures for window clustering (paper §4.2.1 / §4.2.2).

The paper computes, for each vertex ``v``, ``m`` min-hashes of the member set
``W(v)`` and clusters vertices with identical signatures (Jaccard-similar
windows collide with probability ``J(u,v)^m``).

Key implementation insight (also a big host-side win):
the min-hash of a k-hop window satisfies the recurrence

    sig_{r+1}(v) = min( h(v), min_{u in N_out(v)} sig_r(u) )

because ``W_{r+1}(v) = {v} ∪ ⋃_{u∈N_out(v)} W_r(u)``.  So signatures are
computed by ``k`` rounds of *segment-min message passing* — never
materializing any window — which is the same fused gather+segment-reduce
primitive the query data plane uses (``repro_torch/kernels/segment_reduce``).
This strengthens the paper's "compute windows on the fly" memory argument:
clustering needs **no** window materialization at all.

For topological windows one sweep in topological order is exact:
``sig(v) = min(h(v), min_{p in parents(v)} sig(p))``.

EMC (§4.2.2) = run only ``k' < k`` rounds (default 1) and cluster on the
estimated signatures; justified by the paper's Theorem 4.1 corollary that
Jaccard similarity is non-decreasing in hop count.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.graph import Graph

# Odd multipliers for multiply-shift hashing (splitmix64-derived constants).
_MIX = np.uint64(0x9E3779B97F4A7C15)
_MIX2 = np.uint64(0xBF58476D1CE4E5B9)
_MIX3 = np.uint64(0x94D049BB133111EB)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + _MIX).astype(np.uint64)
    x = ((x ^ (x >> np.uint64(30))) * _MIX2).astype(np.uint64)
    x = ((x ^ (x >> np.uint64(27))) * _MIX3).astype(np.uint64)
    return (x ^ (x >> np.uint64(31))).astype(np.uint64)


def vertex_hashes(n: int, num_hashes: int, seed: int = 0) -> np.ndarray:
    """h_i(v) for all v: [n, m] uint64, each column an independent hash."""
    ids = np.arange(n, dtype=np.uint64)[:, None]
    salts = _splitmix64(np.arange(num_hashes, dtype=np.uint64) + np.uint64(seed * 1315423911))
    return _splitmix64(ids * np.uint64(0x100000001B3) ^ salts[None, :])


def minhash_signatures_khop(
    g: Graph, hops: int, num_hashes: int = 4, seed: int = 0
) -> np.ndarray:
    """[n, m] uint64 min-hash signatures of the `hops`-hop windows."""
    sig = vertex_hashes(g.n, num_hashes, seed)
    if g.directed:
        src, dst = g.src, g.dst
    else:
        src = np.concatenate([g.src, g.dst])
        dst = np.concatenate([g.dst, g.src])
    # message passing: sig[src] receives min of sig[dst]?  The recurrence
    # pulls from OUT-neighbors: sig'(v) = min(sig(v), min_{(v,u)} sig(u)).
    # Group edges by the *source* so reduceat reduces over out-neighbors.
    order = np.argsort(src, kind="stable")
    s_sorted, d_sorted = src[order], dst[order]
    s_unique, group_starts = np.unique(s_sorted, return_index=True)
    for _ in range(hops):
        gathered = sig[d_sorted]  # [E, m]
        reduced = np.minimum.reduceat(gathered, group_starts, axis=0)
        new = sig.copy()
        new[s_unique] = np.minimum(new[s_unique], reduced)
        if np.array_equal(new, sig):
            break
        sig = new
    return sig


def minhash_signatures_topo(g: Graph, num_hashes: int = 4, seed: int = 0) -> np.ndarray:
    """Exact min-hash of ancestor windows via one topological sweep."""
    sig = vertex_hashes(g.n, num_hashes, seed)
    for v in g.topological_order():
        ch = g.out_neighbors(v)
        if ch.size:
            sig[ch] = np.minimum(sig[ch], sig[v][None, :])
    return sig


def cluster_by_signature(sig: np.ndarray) -> np.ndarray:
    """Group rows with identical signatures: returns cluster_id [n] int32,
    ids dense in [0, n_clusters)."""
    _, inverse = np.unique(sig, axis=0, return_inverse=True)
    return inverse.astype(np.int32)

"""k-hop reachability sweep on the device (kernel K2).

Reuses the segment-reduce tile plan (segments = destination vertices).  One
hop = one K2 launch for up to ``32 * W`` sources (W 32-bit words, default
128 -> 4096 sources), the device mirror of
:func:`repro_torch.core.windows.khop_reach_bitsets`.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.bitset_expand.bitset_expand import (
    DEFAULT_TM,
    DEFAULT_TS,
    bitset_expand_tiled,
)
from repro_torch.kernels.segment_reduce.ops import TilePlan, build_tile_plan


def build_expand_plan(edge_src: np.ndarray, edge_dst: np.ndarray, n: int,
                      tm: int = DEFAULT_TM, ts: int = DEFAULT_TS,
                      torch_device="cuda") -> TilePlan:
    """Edges must be sorted by dst (DeviceGraph layout)."""
    return build_tile_plan(edge_src, edge_dst, n, tm=tm, ts=ts,
                           torch_device=torch_device)


def bitset_expand(plan: TilePlan, reach: torch.Tensor) -> torch.Tensor:
    """One expansion hop over int32 bitsets ``[n, W]`` -> new ``[n, W]``."""
    return bitset_expand_tiled(
        reach, plan.gather_padded, plan.seg_tiles, plan.m2out,
        num_out_tiles=plan.num_out_tiles, tm=plan.tm, ts=plan.ts,
    )


def seed_bitsets(n: int, sources: np.ndarray, lanes: int = 128) -> np.ndarray:
    """``[n, lanes]`` int32 words with bit ``i`` of row ``sources[i]`` set."""
    sources = np.asarray(sources)
    assert sources.size <= 32 * lanes
    reach0 = np.zeros((n, lanes), dtype=np.uint32)
    cols = np.arange(sources.size)
    np.bitwise_or.at(reach0, (sources, cols // 32),
                     np.uint32(1) << (cols % 32).astype(np.uint32))
    return reach0.view(np.int32)


def khop_reach(plan: TilePlan, n: int, sources: np.ndarray, k: int,
               lanes: int = 128) -> torch.Tensor:
    """Full k-hop sweep for <= 32*lanes sources; returns [n, lanes] int32
    (the reference's uint32 words, bit for bit) on the plan's device."""
    r = torch.from_numpy(seed_bitsets(n, sources, lanes)).to(plan.device)
    for _ in range(k):
        r = bitset_expand(plan, r)
    return r

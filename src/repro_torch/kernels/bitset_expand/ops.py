"""k-hop reachability sweep on the device (kernel K2).

Reuses the segment-reduce tile plan (segments = destination vertices) and
adds the run offsets K2 reads in place of a search.  One hop = one K2
launch for up to ``32 * W`` sources (W 32-bit words, default 128 -> 4096
sources), the device mirror of
:func:`repro_torch.core.windows.khop_reach_bitsets`.  Each hop hands its
occupancy mask to the next; the first hop's comes from the seeds.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.bitset_expand.bitset_expand import (
    DEFAULT_TM,
    DEFAULT_TS,
    bitset_expand_tiled,
    mask_words,
)
from repro_torch.kernels.segment_reduce.ops import TilePlan, _nbytes, build_tile_plan


@dataclasses.dataclass(frozen=True)
class ExpandPlan(TilePlan):
    """The tile plan of the dst-sorted edges plus K2's run offsets: the
    valid plan rows of destination ``v`` are ``gather_padded[row_ptr[v] +
    p : row_ptr[v + 1] + p]`` with ``p = pad_before[v // ts]``.  (One
    ``[n + 1]`` array of padded positions cannot serve: the pad rows at the
    tail of a group sit between the end of its last run and the start of
    the next group's first.)"""

    row_ptr: torch.Tensor  # int32 [n + 1]: CSR offsets over valid rows
    pad_before: torch.Tensor  # int32 [num_out_tiles]

    def array_nbytes(self) -> "dict":
        out = super().array_nbytes()
        out.update(row_ptr=_nbytes(self.row_ptr), pad_before=_nbytes(self.pad_before))
        return out


def build_expand_plan(edge_src: np.ndarray, edge_dst: np.ndarray, n: int,
                      tm: int = DEFAULT_TM, ts: int = DEFAULT_TS,
                      torch_device="cuda") -> ExpandPlan:
    """Edges must be sorted by dst (DeviceGraph layout).  Laid out on the
    host, then uploaded once."""
    dev = resolve_device(torch_device)
    host = build_tile_plan(edge_src, edge_dst, n, tm=tm, ts=ts, torch_device="cpu")
    row_ptr = np.searchsorted(np.asarray(edge_dst), np.arange(n + 1))
    groups = np.arange(host.num_out_tiles)
    first_tile = np.searchsorted(host.m2out.numpy(), groups)
    pad_before = first_tile * tm - row_ptr[np.minimum(groups * ts, n)]
    fields = {f.name: getattr(host, f.name) for f in dataclasses.fields(TilePlan)}
    fields = {k: v.to(dev) if isinstance(v, torch.Tensor) else v
              for k, v in fields.items()}
    fields["device"] = dev
    return ExpandPlan(
        **fields,
        row_ptr=torch.from_numpy(row_ptr.astype(np.int32)).to(dev),
        pad_before=torch.from_numpy(pad_before.astype(np.int32)).to(dev))


def bitset_expand(plan: ExpandPlan, reach: torch.Tensor, mask=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One expansion hop over int32 bitsets ``[n, W]`` (with their
    occupancy mask, computed when not given) -> ``(out, out_mask)``."""
    return bitset_expand_tiled(
        reach, plan.gather_padded, plan.seg_tiles, plan.row_ptr, plan.pad_before,
        mask=mask, num_out_tiles=plan.num_out_tiles, tm=plan.tm, ts=plan.ts,
    )


def _seeds(sources: np.ndarray, lanes: int, mask: bool):
    """(flat indices, uint32 words) of the nonzero words of the seeds'
    bitsets ``[n, lanes]`` (bit ``i`` of row ``sources[i]``) or, with
    ``mask``, of their occupancy mask ``[n, mask_words(lanes)]`` (seed ``i``
    sets group ``i // 128`` of its row); words that two seeds share are
    ORed."""
    sources = np.asarray(sources, np.int64)
    if sources.size > 32 * lanes:
        raise ValueError(f"{sources.size} seeds do not fit {lanes} words a row")
    bit = np.arange(sources.size) // (128 if mask else 1)
    width = mask_words(lanes) if mask else lanes
    keys, inv = np.unique(sources * width + bit // 32, return_inverse=True)
    words = np.zeros(keys.size, np.uint32)
    np.bitwise_or.at(words, inv, np.uint32(1) << (bit % 32).astype(np.uint32))
    return keys, words


def seed_bitsets(n: int, sources: np.ndarray, lanes: int = 128) -> np.ndarray:
    """``[n, lanes]`` int32 words with bit ``i`` of row ``sources[i]`` set."""
    keys, words = _seeds(sources, lanes, mask=False)
    out = np.zeros(n * lanes, dtype=np.uint32)
    out[keys] = words
    return out.reshape(n, lanes).view(np.int32)


def _device(n: int, sources, lanes: int, mask: bool, dev) -> torch.Tensor:
    """:func:`seed_bitsets` (or, with ``mask``, its occupancy mask) written
    on ``dev``: only the nonzero words are uploaded."""
    keys, words = _seeds(sources, lanes, mask)
    t = torch.zeros((n, mask_words(lanes) if mask else lanes), dtype=torch.int32,
                    device=dev)
    t.view(-1).index_copy_(0, torch.from_numpy(keys).to(dev),
                           torch.from_numpy(words.view(np.int32)).to(dev))
    return t


def khop_reach_masked(plan: ExpandPlan, n: int, sources: np.ndarray, k: int,
                      lanes: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`khop_reach` and the result's occupancy mask.  The seeds'
    words and mask are written on the plan's device: a few KB uploaded, not
    the ``[n, lanes]`` bitsets."""
    r = _device(n, sources, lanes, False, plan.device)
    m = _device(n, sources, lanes, True, plan.device)
    for _ in range(k):
        r, m = bitset_expand(plan, r, m)
    return r, m


def khop_reach(plan: ExpandPlan, n: int, sources: np.ndarray, k: int,
               lanes: int = 128) -> torch.Tensor:
    """Full k-hop sweep for <= 32*lanes sources; returns [n, lanes] int32
    (the reference's uint32 words, bit for bit) on the plan's device."""
    return khop_reach_masked(plan, n, sources, k, lanes)[0]

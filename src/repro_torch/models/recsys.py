"""Factorization Machine (Rendle, ICDM'10): serving and training.

39 sparse fields, embed_dim 10, 2-way FM interaction via the O(nk)
sum-square trick (kernel K4, ``kernels/fm_interaction``).  The tables are
one fused ``[total_rows, K]`` matrix held whole on one card (3.21 GB at the
full config) with mod-hash row placement; lookups are plain gathers.

EmbeddingBag is a gather + ``index_add_`` (a segment sum), as in the
reference.  :func:`loss_fn` is the reference's stable logistic loss; in
training on the card the interaction's gradient comes from K4's backward
kernel (``fm_second_order`` takes the autograd route).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.distributed.actshard import is_dtensor
from repro_torch.kernels.fm_interaction.ops import fm_second_order


@dataclasses.dataclass(frozen=True)
class FMConfig:
    name: str
    n_fields: int = 39
    embed_dim: int = 10
    table_sizes: Tuple[int, ...] = ()
    param_dtype: str = "float32"

    @property
    def total_rows(self) -> int:
        return int(sum(self.table_sizes))

    @property
    def offsets(self) -> np.ndarray:
        off = np.zeros(self.n_fields, np.int64)
        np.cumsum(self.table_sizes[:-1], out=off[1:])
        return off

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)


def default_table_sizes(n_fields: int = 39, big: int = 1_000_000,
                        small: int = 10_000) -> Tuple[int, ...]:
    """Criteo-shaped: a few huge ID tables, many small categorical ones."""
    return tuple(big if f % 5 == 0 else small for f in range(n_fields))


def init(generator: torch.Generator, cfg: FMConfig):
    """Random params on ``generator.device`` (normal * 0.01, as the reference)."""
    dev = generator.device

    def normal(shape):
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=dev)
        return (w * 0.01).to(cfg.pdtype)

    return {
        "emb": normal((cfg.total_rows, cfg.embed_dim)),
        "w1": normal((cfg.total_rows,)),
        "bias": torch.zeros((), dtype=cfg.pdtype, device=dev),
    }


def _rows(cfg: FMConfig, x):
    """x: int32 [B, F] raw ids -> global row ids (mod-hash into each table).

    The reference reads the ids as uint32 before the ``%``; torch has no
    uint32 ``%``, so the ids are widened to int64 and taken mod 2**32 first
    (the same value).  Returns int64 (total_rows < 2**31)."""
    sizes = torch.as_tensor(cfg.table_sizes, dtype=torch.int64, device=x.device)
    offs = torch.as_tensor(cfg.offsets, dtype=torch.int64, device=x.device)
    return offs[None, :] + (x.long() % 2**32) % sizes[None, :]



def _lookup(table, rows):
    """``table[rows]``.  A DTensor table (rows over ``"model"``) takes
    ``F.embedding``, which masks the rows another rank holds; the result
    is made whole over the row shards (an all-reduce)."""
    if not is_dtensor(table):
        return table[rows]
    from torch.distributed.tensor import Replicate

    import torch.nn.functional as F

    vec = table.dim() == 1
    out = F.embedding(rows, table[:, None] if vec else table)
    out = out.redistribute(out.device_mesh, [Replicate() if p.is_partial() else p
                                             for p in out.placements])
    return out[..., 0] if vec else out


def _second_order(emb):
    """:func:`fm_second_order` on each rank's batch rows of a DTensor
    (``local_map``: K4 sees a plain contiguous tensor)."""
    if not is_dtensor(emb):
        return fm_second_order(emb)
    from torch.distributed.tensor.experimental import local_map

    pl = list(emb.placements)
    return local_map(fm_second_order, out_placements=pl, in_placements=(pl,),
                     device_mesh=emb.device_mesh)(emb)


def forward(params, x, cfg: FMConfig):
    """x: int32 [B, F] -> logits float32 [B].  The FM interaction goes
    through :func:`fm_second_order`: kernel K4 on a CUDA tensor, its plain
    version on a CPU tensor."""
    rows = _rows(cfg, x)
    emb = _lookup(params["emb"], rows)  # [B, F, K]
    lin = _lookup(params["w1"], rows).sum(dim=-1)  # [B]
    return params["bias"].float() + lin.float() + _second_order(emb.float())


def loss_fn(params, batch, cfg: FMConfig):
    """Mean logistic loss of :func:`forward`'s logits against ``batch["y"]``
    (0/1), in the stable form max(z, 0) - z y + log1p(exp(-|z|))."""
    logits = forward(params, batch["x"], cfg)
    y = batch["y"].float()
    return torch.mean(torch.clamp(logits, min=0) - logits * y
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def embedding_bag(table, ids, bag_ids, num_bags: int, weights=None, mode="sum"):
    """General EmbeddingBag (multi-hot fields): gather + segment-sum.

    table: [R, K]; ids: [N] rows; bag_ids: [N] sorted; -> [num_bags, K]."""
    g = table[ids.long()]
    if weights is not None:
        g = g * weights[:, None]
    out = torch.zeros((num_bags, table.shape[1]), dtype=g.dtype, device=g.device)
    out.index_add_(0, bag_ids.long(), g)
    if mode == "mean":
        cnt = torch.zeros((num_bags,), dtype=g.dtype, device=g.device)
        cnt.index_add_(0, bag_ids.long(), torch.ones_like(bag_ids, dtype=g.dtype))
        out = out / cnt.clamp_min(1.0)[:, None]
    return out


def retrieval_scores(params, query_x, cand_rows, cfg: FMConfig):
    """Score 1 query against N candidate items: batched dot in embedding
    space.  cand_rows: int [N] embedding rows."""
    rows = _rows(cfg, query_x)  # [1, F]
    q = _lookup(params["emb"], rows[0]).sum(dim=0)  # [K]
    return _lookup(params["emb"], cand_rows.long()) @ q

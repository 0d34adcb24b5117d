"""Plain torch oracle for the fused gather + segment-reduce primitive.

This is the paper's entire query data plane as one op (DESIGN.md §2):
``out[s] = op-reduce over { values[gather_idx[i]] : segment_ids[i] == s }``.
"""

from __future__ import annotations

import torch


def segment_reduce_ref(values, gather_idx, segment_ids, num_segments, op="add"):
    """values: [N, D] (or [N]); gather_idx, segment_ids: [M] int tensors.

    Rows with segment_ids < 0 are dropped (padding).  Returns [S, D].
    """
    squeeze = values.dim() == 1
    if squeeze:
        values = values[:, None]
    gathered = values[gather_idx.long().clamp(0, values.shape[0] - 1)]
    valid = segment_ids >= 0
    sid = torch.where(valid, segment_ids, num_segments).long()
    if op == "add":
        reduce, fill = "sum", 0
    elif op in ("min", "max"):
        if values.dtype.is_floating_point:
            fill = float("inf") if op == "min" else float("-inf")
        else:
            info = torch.iinfo(values.dtype)
            fill = info.max if op == "min" else info.min
        reduce = "amin" if op == "min" else "amax"
    else:
        raise ValueError(op)
    gathered = torch.where(valid[:, None], gathered,
                           torch.full((), fill, dtype=values.dtype))
    out = torch.full((num_segments + 1, values.shape[1]), fill,
                     dtype=values.dtype, device=values.device)
    out.scatter_reduce_(0, sid[:, None].expand_as(gathered), gathered,
                        reduce=reduce, include_self=True)
    out = out[:num_segments]
    return out[:, 0] if squeeze else out

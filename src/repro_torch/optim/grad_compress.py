"""Gradient compression for the data-parallel all-reduce.

int8 quantization with **error feedback** (Seide et al. / 1-bit SGD
lineage): the quantization residual is carried in a per-leaf buffer and
added back before the next quantization, so the compressed trajectory
converges to the uncompressed one.  Pure functions over trees of tensors
(:mod:`repro_torch.tree`); the round trip is modelled locally, as in the
reference (the wire format is a runtime concern).

``torch.round`` rounds half to even, as ``jnp.round`` does, so ``q`` and
the scale are the reference's bit for bit.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.tree import leaves, tree_map, unflatten


def init_error_feedback(params) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = x.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def int8_compress_hook(grads, err_state):
    """Returns (compressed-then-decompressed grads, new error state)."""
    new_g, new_e = [], []
    for g, e in zip(leaves(grads), leaves(err_state)):
        g32 = g.to(torch.float32) + e
        q, s = quantize_int8(g32)
        deq = dequantize_int8(q, s)
        new_g.append(deq.to(g.dtype))
        new_e.append(g32 - deq)
    return unflatten(grads, new_g), unflatten(err_state, new_e)

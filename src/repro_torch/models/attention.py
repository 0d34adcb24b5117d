"""Attention dispatch: the flash kernel (K3) on the card, plain torch elsewhere.

``flash_torch`` is the counterpart of the reference's ``flash_jnp``: the
flash kernel's streaming softmax over query and key chunks, O(S * chunk)
memory, and — unlike ``flash_jnp`` — any S (a ragged last chunk is masked
by slicing).  ``local_window`` gives sliding-window attention on the plain
paths; the kernel has none, as the TPU kernel has none.

On the card a call that autograd records (grad mode on, an input requiring
grad: training) goes through
:func:`~repro_torch.kernels.flash_attention.flash_attention.flash_attention_train`,
K3 with its backward kernel; any other call launches K3's forward alone,
as serving always has.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention,
    flash_attention_train,
)
from repro_torch.kernels.flash_attention.ref import flash_torch, mha_ref

__all__ = ["BACKENDS", "attention", "flash_torch"]

#: ``backend=`` values; ``None`` picks one from the device and length
BACKENDS = ("cuda", "flash_torch", "naive")


def attention(q, k, v, *, causal: bool = True, local_window: Optional[int] = None,
              backend: Optional[str] = None, q_chunk: int = 512, kv_chunk: int = 512):
    """q: [B, Hq, S, D]; k/v: [B, Hkv, S, D] -> [B, Hq, S, D].

    ``backend=None`` takes the kernel for CUDA tensors, and on the CPU
    mirrors the reference off the TPU: ``flash_torch`` for S > 1024, the
    materializing ``mha_ref`` otherwise."""
    if backend is None:
        if q.is_cuda:
            backend = "cuda"
        else:
            backend = "flash_torch" if q.shape[2] > 1024 else "naive"
    if backend == "cuda":
        if local_window is not None:
            raise NotImplementedError(
                "the flash-attention kernel has no sliding window; pass "
                "backend='flash_torch' or 'naive' for local_window")
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return flash_attention_train(q, k, v, causal=causal)
        return flash_attention(q, k, v, causal=causal)
    if backend == "flash_torch":
        return flash_torch(q, k, v, causal=causal, local_window=local_window,
                           q_chunk=q_chunk, kv_chunk=kv_chunk)
    if backend == "naive":
        return mha_ref(q, k, v, causal=causal, local_window=local_window)
    raise ValueError(f"backend {backend!r} not in {BACKENDS}")

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

Over a mesh q, k and v are DTensors: each rank runs the same dispatch on
its own ``[B/dp, H/model, S, D]`` pieces (``local_map``), so a kernel only
ever sees a plain contiguous tensor (:func:`_sharded_attention`).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.distributed.actshard import is_dtensor
from repro_torch.kernels.build import plain_route
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

    ``backend=None`` takes the kernel for CUDA tensors (and fake ones: the
    dry-run counts the kernel's route), and on the CPU
    mirrors the reference off the TPU: ``flash_torch`` for S > 1024, the
    materializing ``mha_ref`` otherwise."""
    if is_dtensor(q):
        return _sharded_attention(q, k, v, causal=causal, local_window=local_window,
                                  backend=backend, q_chunk=q_chunk, kv_chunk=kv_chunk)
    if backend is None:
        if not plain_route(q):
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



def head_split(hq: int, hkv: int, tp: int) -> str:
    """How ``tp`` ranks of the ``"model"`` axis split attention's heads:
    ``"both"`` (q and kv heads each split evenly), ``"q"`` (q heads split;
    every rank holds the kv heads and keeps the ones its q heads read) or
    ``"none"`` (every rank computes every head)."""
    if hq % tp:
        return "none"
    if hkv % tp == 0:
        return "both"
    hq_l, group = hq // tp, hq // hkv
    return "q" if (group % hq_l == 0 or hq_l % group == 0) else "none"


def _relayout(t, pl):
    """``t`` redistributed to ``pl`` (batch and heads only), gathering a
    split sequence first: a piece of the sequence becomes a piece of the
    heads by an all-gather over the axis that split it, then a local
    slice, never by moving the batch."""
    from torch.distributed.tensor import Replicate

    whole = [Replicate() if p.is_shard() and p.dim >= 2 else p for p in t.placements]
    if whole != list(t.placements):
        t = t.redistribute(t.device_mesh, whole)
    return t.redistribute(t.device_mesh, pl)


def _sharded_attention(q, k, v, **kw):
    """:func:`attention` on DTensors, each rank on its own heads
    (:func:`on_local_heads`)."""
    return on_local_heads(lambda ql, kl, vl: attention(ql, kl, vl, **kw), q, k, v)


def on_local_heads(fn, q, k, v):
    """``fn(q, k, v)`` on DTensors, each rank on its own plain contiguous
    pieces: batch (dim 0) over the dp axes, heads (dim 1: q [B, Hq, ...],
    k and v [B, Hkv, ...]) over ``"model"`` as :func:`head_split` says,
    every other dimension whole (a sequence split over the mesh is
    gathered; a batch the dp axes do not divide, one long sequence, is
    replicated over them).  Where the kv heads are not split (``"q"``), each rank
    slices the ones its q heads read, so the gradient it returns for k and
    v is a partial sum over the model axis (``in_grad_placements``), not a
    replicated one.  The result is laid out as q."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    names = tuple(mesh.mesh_dim_names)
    tp = mesh.size(names.index("model")) if "model" in names else 1
    hq, hkv = q.shape[1], k.shape[1]
    split = head_split(hq, hkv, tp)
    ndp = 1
    for i, n in enumerate(names):
        ndp *= mesh.size(i) if n in ("pod", "data") else 1
    batch = Shard(0) if q.shape[0] % ndp == 0 else Replicate()

    def layout(heads: bool, grad_partial: bool = False):
        return [batch if n in ("pod", "data") else
                Shard(1) if heads else Partial() if grad_partial else Replicate()
                for n in names]

    q_pl = layout(split != "none")
    kv_pl = layout(split == "both")
    q, k, v = (_relayout(t, pl) for t, pl in ((q, q_pl), (k, kv_pl), (v, kv_pl)))
    model_rank = mesh.get_local_rank("model") if "model" in names else 0

    def local(ql, kl, vl):
        if split == "q":
            lo = model_rank * (hq // tp) * hkv // hq
            n = max(1, (hq // tp) * hkv // hq)
            kl, vl = kl[:, lo:lo + n], vl[:, lo:lo + n]
        return fn(ql.contiguous(), kl.contiguous(), vl.contiguous())

    kv_grad = layout(False, grad_partial=True) if split == "q" else kv_pl
    return local_map(local, out_placements=q_pl, in_placements=(q_pl, kv_pl, kv_pl),
                     in_grad_placements=(q_pl, kv_grad, kv_grad),
                     device_mesh=mesh)(q, k, v)

"""Plain PyTorch attention: the oracles, and the chunked plain version of K3.

* :func:`mha_ref` — causal GQA attention that materializes the score
  matrix, in the input dtype (the reference's ``mha_ref``: in bf16 its
  scores and softmax round to bf16).
* :func:`decode_ref` — one decode step over a KV cache, scores and softmax
  in float32, p rounded to the cache dtype before the PV product.
* :func:`flash_torch` — the streaming-softmax algorithm of the flash kernel
  over query and key chunks, O(S * chunk) memory, float32 scores, p and
  accumulator (the reference's ``flash_jnp``).  A ragged last chunk (S not
  a multiple of the chunk) is sliced, not reshaped, so any S >= 1 runs.
  ``p_dtype`` rounds p to that dtype before the PV product, as the kernels
  do for bf16 (the row sums keep the unrounded p).
  Chunks wholly outside the mask are skipped; that gives the same bits as
  the reference's full scan, where such a chunk adds p = 0 with alpha = 1,
  or is wiped by alpha = 0 at the first valid chunk.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG = -1e30


def _sqrt_d(d: int, dtype) -> torch.Tensor:
    # jnp.sqrt(d) is float32, then cast to the working dtype
    return torch.tensor(math.sqrt(d), dtype=torch.float32).to(dtype)


def mha_ref(q, k, v, causal: bool = True, local_window: Optional[int] = None):
    """q: [B, Hq, S, D]; k, v: [B, Hkv, S, D]; Hq % Hkv == 0 (GQA).

    Returns [B, Hq, S, D].  ``local_window`` masks keys further than W back.
    """
    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / _sqrt_d(
        d, q.dtype).to(q.device)
    qi = torch.arange(s, device=q.device)[:, None]
    ki = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if local_window is not None:
        mask &= ki > qi - local_window
    scores = scores.masked_fill(~mask, float("-inf"))
    return torch.einsum("bhqk,bhkd->bhqd", _softmax(scores), v)


def _softmax(x):
    m = x.amax(dim=-1, keepdim=True)
    e = torch.exp(x - m)
    return e / e.sum(dim=-1, keepdim=True)


def decode_ref(q, k_cache, v_cache, length, window: Optional[int] = None):
    """One decode step.  q: [B, Hq, D]; caches: [B, Hkv, S, D]; length: int
    or [B] valid cache entries.  Returns [B, Hq, D].

    GQA via a grouped einsum: the cache is never repeated to Hq heads.
    ``window`` masks keys older than ``length - window``.
    """
    b, hq, d = q.shape
    hkv = k_cache.shape[1]
    qg = q.reshape(b, hkv, hq // hkv, d)
    # bf16 products are exact in float32: this is the reference's bf16
    # einsum with preferred_element_type=float32
    scores = torch.einsum("bhgd,bhsd->bhgs", qg.float(), k_cache.float()) / (
        _sqrt_d(d, torch.float32).to(q.device))
    s = k_cache.shape[2]
    length = torch.as_tensor(length, device=q.device).reshape(-1, 1)
    pos = torch.arange(s, device=q.device)[None, :]
    valid = pos < length
    if window is not None:
        valid &= pos >= length - window
    scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
    p = _softmax(scores).to(v_cache.dtype)
    out = torch.einsum("bhgs,bhsd->bhgd", p, v_cache)
    return out.reshape(b, hq, d)


def flash_torch(q, k, v, *, causal: bool = True, q_chunk: int = 512,
                kv_chunk: int = 512, local_window: Optional[int] = None,
                p_dtype: Optional[torch.dtype] = None):
    """q: [B, Hq, S, D]; k/v: [B, Hkv, S, D] -> [B, Hq, S, D] (f32 acc)."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    group = hq // hkv
    scale = d ** -0.5
    q_chunk = min(q_chunk, s)
    kv_chunk = min(kv_chunk, s)
    qr = q.reshape(b, hkv, group, s, d)
    out = torch.empty((b, hkv, group, s, d), dtype=q.dtype, device=q.device)
    for q0 in range(0, s, q_chunk):
        q1 = min(q0 + q_chunk, s)
        qblk = qr[:, :, :, q0:q1].float()  # [B, Hkv, G, qc, D]
        rows = torch.arange(q0, q1, device=q.device)[:, None]
        m = torch.full(qblk.shape[:-1], NEG, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qblk)
        for k0 in range(0, s, kv_chunk):
            k1 = min(k0 + kv_chunk, s)
            if causal and k0 > q1 - 1:
                break  # every key of the chunk is past every row
            if local_window is not None and k1 - 1 <= q0 - local_window:
                continue  # every key of the chunk is out of every row's window
            sc = torch.einsum("bhgqd,bhkd->bhgqk", qblk,
                              k[:, :, k0:k1].float()) * scale
            cols = torch.arange(k0, k1, device=q.device)[None, :]
            mask = torch.ones((q1 - q0, k1 - k0), dtype=torch.bool,
                              device=q.device)
            if causal:
                mask &= cols <= rows
            if local_window is not None:
                mask &= cols > rows - local_window
            sc = torch.where(mask, sc, NEG)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            if p_dtype is not None:
                p = p.to(p_dtype).float()
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", p, v[:, :, k0:k1].float())
            m = m_new
        out[:, :, :, q0:q1] = (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)
    return out.reshape(b, hq, s, d)

"""Shared layers (functional, plain tensors).

Conventions, as in the reference:

* params are nested dicts of tensors; init functions draw from a
  :class:`torch.Generator` on the generator's device, in float32, and cast;
* weights are ``[d_in, d_out]`` and used as ``x @ w``;
* normalization runs in float32 and casts back; RoPE's cos and sin are
  cast to the activations' dtype before the multiply.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32, scale: Optional[float] = None):
    scale = scale if scale is not None else d_in ** -0.5
    w = torch.randn((d_in, d_out), generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (w * scale).to(dtype)


def embed_init(generator: torch.Generator, vocab: int, d: int,
               dtype=torch.float32):
    w = torch.randn((vocab, d), generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (w * 0.02).to(dtype)


def rmsnorm_init(d: int, dtype=torch.float32, device=None):
    return torch.ones((d,), dtype=dtype, device=device)


def rmsnorm(x, gamma, eps: float = 1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * gamma.float()).to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def rope_freqs(head_dim: int, max_seq: int, theta: float = 10000.0,
               device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    inv = 1.0 / (theta ** (exps / head_dim))
    t = torch.arange(max_seq, dtype=torch.float32, device=device)
    ang = torch.outer(t, inv)  # [S, D/2]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin, positions=None):
    """x: [..., S, D]; cos/sin: [S_max, D/2] (gathered at ``positions`` if given)."""
    if positions is not None:
        cos = cos[positions]
        sin = sin[positions]
    x1, x2 = x.chunk(2, dim=-1)
    shape = (1,) * (x.dim() - 2) + tuple(cos.shape)
    cos = cos.reshape(shape).to(x.dtype)
    sin = sin.reshape(shape).to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def mlp_init(generator: torch.Generator, dims, dtype=torch.float32):
    """Simple MLP: list of {w, b} for dims [d0, d1, ..., dn]."""
    return [
        {"w": dense_init(generator, a, b, dtype),
         "b": torch.zeros((b,), dtype=dtype, device=generator.device)}
        for a, b in zip(dims[:-1], dims[1:])
    ]


def mlp_apply(params, x, act=F.relu, final_act: bool = False):
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i < len(params) - 1 or final_act:
            x = act(x)
    return x


def _chunk_nll(xi, w, li, z_loss: float, acts=None):
    """Summed NLL (+ z-loss) of one sequence chunk: ``xi`` [B, c, D] against
    ``w`` [D, V] (already in ``xi``'s dtype), labels ``li`` [B, c]."""
    from repro_torch.distributed.actshard import constrain

    logits = constrain((xi @ w).float(), acts, "loss_logits")
    lse, ll = _lse_and_label_logit(logits, li)
    nll = lse - ll
    if z_loss:
        nll = nll + z_loss * torch.square(lse)
    return torch.sum(nll)


def _lse_and_label_logit(logits, labels):
    """``(logsumexp over the last dimension, each row's logit at its
    label)``.  On a plain tensor: ``torch.logsumexp`` and a gather.  On
    vocab-split DTensor logits, Megatron's vocab-parallel form: the row max
    over the shards (an all-reduce of a max, held constant), then on each
    rank (``local_map``) its own shard's sum of exponentials and its masked
    label logit (the reference's masked sum: exact, one term is not zero),
    each a partial sum over the vocab shards, combined by an all-reduce.
    No rank gathers the logits, forward or backward.  (The vocab splits
    evenly over its shards, as the specs split it.)"""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    if not isinstance(logits, DTensor):
        ll = logits.gather(-1, labels[..., None].long()).squeeze(-1)
        return torch.logsumexp(logits, dim=-1), ll
    mesh, last = logits.device_mesh, logits.dim() - 1
    pl = list(logits.placements)
    vocab_dims = [i for i, p in enumerate(pl) if p == Shard(last)]
    index = 0
    for i in vocab_dims:
        index = index * mesh.size(i) + mesh.get_local_rank(i)
    row_pl = [Replicate() if i in vocab_dims else p for i, p in enumerate(pl)]
    part_pl = [Partial() if i in vocab_dims else p for i, p in enumerate(pl)]
    m = logits.detach().amax(dim=-1).redistribute(mesh, row_pl)
    labels = labels.redistribute(mesh, row_pl)

    def local(lg, m_l, lab):
        size = lg.shape[-1]
        ids = torch.arange(index * size, (index + 1) * size, device=lg.device)
        se = torch.exp(lg - m_l[..., None]).sum(dim=-1)
        ll = torch.where(ids == lab[..., None], lg, 0.0).sum(dim=-1)
        return se, ll

    se, ll = local_map(local, out_placements=(part_pl, part_pl),
                       in_placements=(pl, row_pl, row_pl), device_mesh=mesh)(logits, m, labels)
    return m + se.redistribute(mesh, row_pl).log(), ll.redistribute(mesh, row_pl)


def lm_loss_fused(x, w, labels, z_loss: float = 0.0, chunk: int = 512, acts=None):
    """Fused unembed + cross entropy, chunked over the sequence axis.

    Never builds the whole [B, S, V] logits: each chunk's logits are
    produced, reduced to its summed NLL and, under one
    ``torch.utils.checkpoint`` a chunk, recomputed in the backward.  The
    chunk is ``chunk`` or, as in the reference, the largest length below it
    that divides S (S = 2047 gives chunks of 89).  The chunks' sums are
    added in order, as the reference's scan adds them.

    x: [B, S, D] final hidden states; w: [D, V]; labels: [B, S].  Returns
    the mean over B * S.  Over a mesh (DTensors) the hidden states are
    anchored at ``acts["loss_hidden"]`` and each chunk's logits at
    ``acts["loss_logits"]``, as the reference anchors them."""
    from repro_torch.distributed.actshard import constrain

    b, s, _ = x.shape
    x = constrain(x, acts, "loss_hidden")
    chunk = min(chunk, s)
    while s % chunk:
        chunk -= 1
    wc = w.to(x.dtype)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, chunk):
        xi, li = x[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
        if torch.is_grad_enabled():
            part = checkpoint(_chunk_nll, xi, wc, li, z_loss, acts, use_reentrant=False)
        else:
            part = _chunk_nll(xi, wc, li, z_loss, acts)
        total = total + part
    return total / (b * s)


def cross_entropy(logits, labels, z_loss: float = 0.0):
    """logits: [..., V]; labels int.  Mean NLL (+ optional z-loss), in float32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    nll = lse - logits.gather(-1, labels[..., None].long()).squeeze(-1)
    if z_loss:
        nll = nll + z_loss * torch.square(lse)
    return torch.mean(nll)

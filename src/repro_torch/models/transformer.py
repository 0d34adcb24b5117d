"""Dense decoder-only transformer: GQA + RoPE + SwiGLU (+ optional qk-norm).

The reference's ``models/transformer.py``: qwen3-0.6b and minitron exactly
(their public configs), forward, training loss, prefill and decode.  Params
are a dict with the layers as a list of per-layer dicts (the reference
stacks them ``[L, ...]`` for ``lax.scan``; the port loops).

Every matmul weight is cast to the compute dtype at its use, as the
reference casts its float32 params.  For serving, :func:`init` holds the
embedding and the matmul weights in the compute dtype already, so the cast
is a no-op and each decode step spares a re-read of float32 weights; for
training, :func:`init_master` holds every param in the param dtype
(float32 masters, the reference's ``init``), so an optimizer step is not
lost to bf16 rounding.  Norm gains stay in the param dtype (they are used
in float32).  ``cfg.remat`` checkpoints each layer in training
(``torch.utils.checkpoint``): the backward recomputes it, attention kernel
included.

Functional API:
    params = init(generator, cfg)                  serving dtypes
    params = init_master(generator, cfg)           float32 masters
    logits = forward(params, tokens, cfg)          [B, S, V]
    loss   = loss_fn(params, batch, cfg)
    kv, logits = prefill(params, tokens, cfg)
    logits, kv = decode_step(params, token, kv, pos, cfg)

Each takes ``acts=``, the reference's activation layouts
(:mod:`repro_torch.distributed.actshard`): over a mesh the params and
tokens are DTensors and the residual stream, logits and loss are anchored
where the reference anchors them; on plain tensors ``acts`` changes
nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.actshard import constrain, is_dtensor
from repro_torch.kernels.flash_attention.ref import decode_ref
from repro_torch.models import layers as L
from repro_torch.models.attention import attention

#: per-layer weights used in matmuls (held in the compute dtype)
MATMUL_WEIGHTS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    qk_norm: bool = False
    rope_theta: float = 10000.0
    max_seq: int = 32768 * 16 + 4096
    tie_embeddings: bool = False
    local_window: Optional[int] = None  # sliding-window attention (plain paths)
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # checkpoint each layer in training (recomputed in the backward)
    remat: bool = True
    z_loss: float = 1e-4
    # flash_torch chunking (the kernel tiles on its own)
    attn_q_chunk: int = 512
    attn_kv_chunk: int = 512

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def n_params(self) -> int:
        d, f, v, l = self.d_model, self.d_ff, self.vocab, self.n_layers
        hd = self.head_dim
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) + (self.n_heads * hd) * d
        ffn = 3 * d * f
        per_layer = attn + ffn + 2 * d
        emb = v * d * (1 if self.tie_embeddings else 2)
        return l * per_layer + emb + d


def port_dtype(name: str, cfg: TransformerConfig) -> torch.dtype:
    """The dtype the port holds param ``name`` in (see the module note)."""
    if name in MATMUL_WEIGHTS or name in ("embed", "unembed"):
        return cfg.cdtype
    return cfg.pdtype


def master_dtype(name: str, cfg: TransformerConfig) -> torch.dtype:
    """The dtype training holds param ``name`` in: the param dtype."""
    return cfg.pdtype


def layer_init(generator: torch.Generator, cfg: TransformerConfig, dtype_of=port_dtype):
    d, hd = cfg.d_model, cfg.head_dim
    dev = generator.device

    def dense(name, d_in, d_out):
        return L.dense_init(generator, d_in, d_out, dtype_of(name, cfg))

    p = {
        "ln1": L.rmsnorm_init(d, cfg.pdtype, dev),
        "ln2": L.rmsnorm_init(d, cfg.pdtype, dev),
        "wq": dense("wq", d, cfg.n_heads * hd),
        "wk": dense("wk", d, cfg.n_kv_heads * hd),
        "wv": dense("wv", d, cfg.n_kv_heads * hd),
        "wo": dense("wo", cfg.n_heads * hd, d),
        "w_gate": dense("w_gate", d, cfg.d_ff),
        "w_up": dense("w_up", d, cfg.d_ff),
        "w_down": dense("w_down", cfg.d_ff, d),
    }
    if cfg.qk_norm:
        p["q_norm"] = L.rmsnorm_init(hd, cfg.pdtype, dev)
        p["k_norm"] = L.rmsnorm_init(hd, cfg.pdtype, dev)
    return p


def init(generator: torch.Generator, cfg: TransformerConfig, dtype_of=port_dtype):
    """Random params on ``generator.device``, drawn in float32 as the
    reference draws them (normal, scaled) and cast to ``dtype_of(name,
    cfg)``: the port's serving dtypes by default."""
    params = {
        "embed": L.embed_init(generator, cfg.vocab, cfg.d_model, dtype_of("embed", cfg)),
        "layers": [layer_init(generator, cfg, dtype_of) for _ in range(cfg.n_layers)],
        "ln_f": L.rmsnorm_init(cfg.d_model, cfg.pdtype, generator.device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = L.dense_init(generator, cfg.d_model, cfg.vocab,
                                         dtype_of("unembed", cfg))
    return params


def init_master(generator: torch.Generator, cfg: TransformerConfig):
    """:func:`init`'s draws with every param in the param dtype: the
    float32 masters training updates."""
    return init(generator, cfg, master_dtype)


def embed(params, tokens, cfg: TransformerConfig):
    """The token rows of the embedding, in the compute dtype.  A DTensor
    table (vocab over ``"model"``) takes ``F.embedding``, whose lookup
    masks the rows another rank holds; the rows are then summed over the
    vocab shards (an all-reduce)."""
    table = params["embed"]
    if is_dtensor(table):
        from torch.distributed.tensor import Replicate

        rows = F.embedding(tokens.long(), table)
        rows = rows.redistribute(rows.device_mesh, [Replicate() if p.is_partial() else p
                                                    for p in rows.placements])
        return rows.to(cfg.cdtype)
    return table[tokens.long()].to(cfg.cdtype)



def _unembed(params, cfg: TransformerConfig):
    w = params.get("unembed")
    w = w if w is not None else params["embed"].T
    return w.to(cfg.cdtype)


def _qkv(lp, x, cfg: TransformerConfig, positions, cos, sin):
    b, s, _ = x.shape
    hd = cfg.head_dim
    xn = _whole_sequence(L.rmsnorm(x, lp["ln1"]))
    cd = cfg.cdtype
    q = _split_heads(xn @ lp["wq"].to(cd), cfg.n_heads, hd)
    k = _split_heads(xn @ lp["wk"].to(cd), cfg.n_kv_heads, hd)
    v = _split_heads(xn @ lp["wv"].to(cd), cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = L.rmsnorm(q, lp["q_norm"])
        k = L.rmsnorm(k, lp["k_norm"])
    q = L.apply_rope(q.transpose(1, 2), cos, sin, positions).contiguous()  # [B, H, S, D]
    k = L.apply_rope(k.transpose(1, 2), cos, sin, positions).contiguous()
    return q, k, v.transpose(1, 2).contiguous()


def _whole_sequence(x):
    """A DTensor residual [B, S, d] split over its sequence (the ``res``
    layout) gathered over it before a projection (sequence parallelism's
    all-gather); a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    pl = [Replicate() if p == Shard(1) else p for p in x.placements]
    return x.redistribute(x.device_mesh, pl) if pl != list(x.placements) else x


def _merge_heads(o):
    """[B, H, S, D] -> [B, S, H * D].  A DTensor whose heads are not split
    (a head count the model axis does not divide) is merged on each rank's
    own piece (``local_map``), so the gradient coming back, split over
    H * D, is gathered before it is unflattened into heads."""
    b, h, s, d = o.shape
    if not is_dtensor(o) or any(p.is_shard(1) for p in o.placements):
        return o.transpose(1, 2).reshape(b, s, h * d)
    from torch.distributed.tensor.experimental import local_map

    pl = list(o.placements)
    return local_map(lambda t: t.transpose(1, 2).reshape(t.shape[0], s, h * d),
                     out_placements=pl, in_placements=(pl,),
                     device_mesh=o.device_mesh)(o)


def _split_heads(y, heads: int, hd: int):
    """[B, S, heads * hd] -> [B, S, heads, hd].  A DTensor whose last
    dimension is split over a mesh axis that does not divide ``heads`` is
    gathered over that axis first (a shard would cut a head)."""
    b, s = y.shape[:2]
    if is_dtensor(y):
        from torch.distributed.tensor import Replicate, Shard

        mesh = y.device_mesh
        pl = [Replicate() if p == Shard(2) and heads % mesh.size(i) else p
              for i, p in enumerate(y.placements)]
        if pl != list(y.placements):
            y = y.redistribute(mesh, pl)
    return y.reshape(b, s, heads, hd)


def _dense_ffn(lp, xn):
    """The dense layer's MLP: one SwiGLU on the normalized residual."""
    return L.swiglu(xn, lp["w_gate"].to(xn.dtype), lp["w_up"].to(xn.dtype),
                    lp["w_down"].to(xn.dtype))


def _mix(lp, x, o, cfg: TransformerConfig, ffn=_dense_ffn):
    """The residual adds around attention output ``o`` [B, H, S, D] and the
    layer's feed-forward ``ffn(lp, xn)`` (the MoE model passes its own)."""
    x = x + _merge_heads(o) @ lp["wo"].to(cfg.cdtype)
    return x + ffn(lp, _whole_sequence(L.rmsnorm(x, lp["ln2"])))


def _layers(params, x, cfg: TransformerConfig, attn_backend: Optional[str],
            ffn=_dense_ffn, acts=None):
    """Run every layer over the prompt: (hidden states, per-layer k, v)."""
    cos, sin = L.rope_freqs(cfg.head_dim, x.shape[1], cfg.rope_theta, x.device)
    ks, vs = [], []
    x = constrain(x, acts, "res")
    for lp in params["layers"]:
        q, k, v = _qkv(lp, x, cfg, None, cos, sin)
        o = attention(q, k, v, causal=True, local_window=cfg.local_window,
                      backend=attn_backend, q_chunk=cfg.attn_q_chunk,
                      kv_chunk=cfg.attn_kv_chunk)
        x = constrain(_mix(lp, x, o, cfg, ffn), acts, "res")
        ks.append(k)
        vs.append(v)
    return L.rmsnorm(x, params["ln_f"]), ks, vs


def forward(params, tokens, cfg: TransformerConfig,
            attn_backend: Optional[str] = None, acts=None):
    """tokens: int [B, S] -> logits float32 [B, S, V]."""
    x, _, _ = _layers(params, embed(params, tokens, cfg), cfg, attn_backend, acts=acts)
    return constrain((x @ _unembed(params, cfg)).float(), acts, "logits")


def layer_fwd(lp, x, cfg: TransformerConfig, cos, sin, positions=None,
              attn_backend: Optional[str] = None):
    """One layer over ``x`` [B, S, d]."""
    q, k, v = _qkv(lp, x, cfg, positions, cos, sin)
    o = attention(q, k, v, causal=True, local_window=cfg.local_window,
                  backend=attn_backend, q_chunk=cfg.attn_q_chunk,
                  kv_chunk=cfg.attn_kv_chunk)
    return _mix(lp, x, o, cfg)


def run_layer(layer_fn, lp, x, cfg, cos, sin, attn_backend):
    """``layer_fn(lp, x, cfg, cos, sin, attn_backend=...)``, under one
    ``torch.utils.checkpoint`` when ``cfg.remat`` is set and autograd is
    recording: the backward recomputes the layer from its input."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(layer_fn, lp, x, cfg, cos, sin, None, attn_backend,
                          use_reentrant=False)
    return layer_fn(lp, x, cfg, cos, sin, None, attn_backend)


def forward_hidden(params, tokens, cfg: TransformerConfig, layer_fn=layer_fwd,
                   attn_backend: Optional[str] = None, acts=None):
    """tokens -> final hidden states [B, S, D] (pre-unembed)."""
    x = constrain(embed(params, tokens, cfg), acts, "res")
    cos, sin = L.rope_freqs(cfg.head_dim, tokens.shape[1], cfg.rope_theta, x.device)
    for lp in params["layers"]:
        x = constrain(run_layer(layer_fn, lp, x, cfg, cos, sin, attn_backend), acts, "res")
    return L.rmsnorm(x, params["ln_f"])


def loss_fn(params, batch, cfg: TransformerConfig, layer_fn=layer_fwd,
            attn_backend: Optional[str] = None, acts=None):
    """Next-token loss of ``batch`` ({"tokens", "labels"} [B, S]): the fused
    chunked cross entropy (+ z-loss) of positions 0..S-2 against labels
    1..S-1, the mean over B * (S - 1)."""
    x = forward_hidden(params, batch["tokens"], cfg, layer_fn, attn_backend, acts)
    return L.lm_loss_fused(x[:, :-1], _unembed(params, cfg), batch["labels"][:, 1:],
                           cfg.z_loss, acts=acts)


def cache_update_add(cache, new, pos: int):
    """Write ``new`` [B, H, D] into ``cache`` [B, H, S, D] at position ``pos``.

    The reference adds a one-hot mask into a zero-initialized cache; the
    port writes the slot in place, which gives the same values because the
    free space is zero.  Returns ``cache`` (updated in place).  A DTensor
    cache is written in place on the rank whose sequence piece holds
    ``pos``, from ``new`` laid out as the cache's batch and heads."""
    if not is_dtensor(cache):
        cache[:, :, pos] = new
        return cache
    from torch.distributed.tensor import Replicate, Shard

    mesh, pl = cache.device_mesh, list(cache.placements)
    shards, index = 1, 0
    for i, p in enumerate(pl):
        if p == Shard(2):
            shards, index = shards * mesh.size(i), index * mesh.size(i) + mesh.get_local_rank(i)
    size = cache.shape[2] // shards
    if shards * size != cache.shape[2]:
        raise ValueError(f"a cache of {cache.shape[2]} positions over {shards} pieces")
    rows = new.redistribute(mesh, [Replicate() if p == Shard(2) else p for p in pl])
    if index * size <= pos < (index + 1) * size:
        cache.to_local()[:, :, pos - index * size] = rows.to_local()
    return cache


def _decode_attention(q, k_cache, v_cache, length: int, window):
    """``decode_ref`` of one token against the caches; on DTensors each
    rank attends with its own heads over the whole sequence (a cache whose
    sequence is split over the mesh is gathered first)."""
    if not is_dtensor(q):
        return decode_ref(q, k_cache, v_cache, length, window=window)
    from repro_torch.models.attention import on_local_heads

    return on_local_heads(lambda ql, kl, vl: decode_ref(ql, kl, vl, length, window=window),
                          q, k_cache, v_cache)


# ---------------------------- serving ---------------------------------- #
def prefill(params, tokens, cfg: TransformerConfig,
            attn_backend: Optional[str] = None, acts=None):
    """Run the prompt, return (kv_cache, last-token logits).

    kv cache: dict of k/v stacked [L, B, Hkv, S, D].  ``attn_backend`` is
    :func:`~repro_torch.models.attention.attention`'s ``backend``."""
    x, ks, vs = _layers(params, embed(params, tokens, cfg), cfg, attn_backend, acts=acts)
    logits = constrain((x[:, -1] @ _unembed(params, cfg)).float(), acts, "logits")
    return {"k": torch.stack(ks), "v": torch.stack(vs)}, logits


def decode_step(params, token, kv, pos: int, cfg: TransformerConfig, acts=None):
    """One token for the whole batch against a full KV cache.

    token: int [B]; kv: {"k","v": [L, B, Hkv, S, D]}, updated in place;
    pos: current length.  Returns (logits [B, V], kv)."""
    x = _decode_layers(params, token, kv, pos, cfg, acts=acts)
    return constrain((x[:, 0] @ _unembed(params, cfg)).float(), acts, "logits"), kv


def _decode_layers(params, token, kv, pos: int, cfg: TransformerConfig,
                   ffn=_dense_ffn, acts=None):
    """Every layer for one token a row: the final-normed hidden states
    [B, 1, d]; ``kv`` is written in place at ``pos``."""
    b = token.shape[0]
    x = constrain(embed(params, token, cfg)[:, None, :], acts, "res")
    smax = kv["k"].shape[3]
    cos, sin = L.rope_freqs(cfg.head_dim, smax, cfg.rope_theta, x.device)
    positions = torch.full((1,), pos, dtype=torch.long, device=x.device)
    for i, lp in enumerate(params["layers"]):
        q, k, v = _qkv(lp, x, cfg, positions, cos, sin)
        kc = cache_update_add(kv["k"][i], k[:, :, 0], pos)
        vc = cache_update_add(kv["v"][i], v[:, :, 0], pos)
        o = _decode_attention(q[:, :, 0], kc, vc, pos + 1, cfg.local_window)
        x = constrain(_mix(lp, x, o.reshape(b, cfg.n_heads, 1, cfg.head_dim), cfg, ffn),
                      acts, "res")
    return L.rmsnorm(x, params["ln_f"])

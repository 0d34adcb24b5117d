"""Dense decoder-only transformer: GQA + RoPE + SwiGLU (+ optional qk-norm).

The serving half of the reference's ``models/transformer.py``: qwen3-0.6b
and minitron exactly (their public configs), forward, prefill and decode.
Params are a dict with the layers as a list of per-layer dicts (the
reference stacks them ``[L, ...]`` for ``lax.scan``; the port loops).

The port holds the embedding and every matmul weight in the compute dtype:
the reference casts its float32 params to the compute dtype at every use,
so casting once at load gives the same bits and spares each decode step a
re-read of the float32 weights.  Norm gains stay in the param dtype (they
are used in float32).

Functional API:
    params = init(generator, cfg)
    logits = forward(params, tokens, cfg)          [B, S, V]
    kv, logits = prefill(params, tokens, cfg)
    logits, kv = decode_step(params, token, kv, pos, cfg)
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

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
    # the reference's backward checkpointing of each layer: no effect in a
    # forward-only port (serving), kept so configs read the same
    remat: bool = True
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


def layer_init(generator: torch.Generator, cfg: TransformerConfig):
    d, hd = cfg.d_model, cfg.head_dim
    dev = generator.device

    def dense(name, d_in, d_out):
        return L.dense_init(generator, d_in, d_out, port_dtype(name, cfg))

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


def init(generator: torch.Generator, cfg: TransformerConfig):
    """Random params on ``generator.device``, drawn in float32 as the
    reference draws them (normal, scaled) and cast to the port's dtypes."""
    params = {
        "embed": L.embed_init(generator, cfg.vocab, cfg.d_model, cfg.cdtype),
        "layers": [layer_init(generator, cfg) for _ in range(cfg.n_layers)],
        "ln_f": L.rmsnorm_init(cfg.d_model, cfg.pdtype, generator.device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = L.dense_init(generator, cfg.d_model, cfg.vocab,
                                         cfg.cdtype)
    return params


def _unembed(params):
    w = params.get("unembed")
    return w if w is not None else params["embed"].T


def _qkv(lp, x, cfg: TransformerConfig, positions, cos, sin):
    b, s, _ = x.shape
    hd = cfg.head_dim
    xn = L.rmsnorm(x, lp["ln1"])
    q = (xn @ lp["wq"]).reshape(b, s, cfg.n_heads, hd)
    k = (xn @ lp["wk"]).reshape(b, s, cfg.n_kv_heads, hd)
    v = (xn @ lp["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = L.rmsnorm(q, lp["q_norm"])
        k = L.rmsnorm(k, lp["k_norm"])
    q = L.apply_rope(q.transpose(1, 2), cos, sin, positions).contiguous()  # [B, H, S, D]
    k = L.apply_rope(k.transpose(1, 2), cos, sin, positions).contiguous()
    return q, k, v.transpose(1, 2).contiguous()


def _dense_ffn(lp, xn):
    """The dense layer's MLP: one SwiGLU on the normalized residual."""
    return L.swiglu(xn, lp["w_gate"], lp["w_up"], lp["w_down"])


def _mix(lp, x, o, cfg: TransformerConfig, ffn=_dense_ffn):
    """The residual adds around attention output ``o`` [B, H, S, D] and the
    layer's feed-forward ``ffn(lp, xn)`` (the MoE model passes its own)."""
    b, s = x.shape[:2]
    o = o.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.head_dim)
    x = x + o @ lp["wo"]
    return x + ffn(lp, L.rmsnorm(x, lp["ln2"]))


def _layers(params, x, cfg: TransformerConfig, attn_backend: Optional[str],
            ffn=_dense_ffn):
    """Run every layer over the prompt: (hidden states, per-layer k, v)."""
    cos, sin = L.rope_freqs(cfg.head_dim, x.shape[1], cfg.rope_theta, x.device)
    ks, vs = [], []
    for lp in params["layers"]:
        q, k, v = _qkv(lp, x, cfg, None, cos, sin)
        o = attention(q, k, v, causal=True, local_window=cfg.local_window,
                      backend=attn_backend, q_chunk=cfg.attn_q_chunk,
                      kv_chunk=cfg.attn_kv_chunk)
        x = _mix(lp, x, o, cfg, ffn)
        ks.append(k)
        vs.append(v)
    return L.rmsnorm(x, params["ln_f"]), ks, vs


def forward(params, tokens, cfg: TransformerConfig,
            attn_backend: Optional[str] = None):
    """tokens: int [B, S] -> logits float32 [B, S, V]."""
    x = params["embed"][tokens.long()].to(cfg.cdtype)
    x, _, _ = _layers(params, x, cfg, attn_backend)
    return (x @ _unembed(params)).float()


def cache_update_add(cache, new, pos: int):
    """Write ``new`` [B, H, D] into ``cache`` [B, H, S, D] at position ``pos``.

    The reference adds a one-hot mask into a zero-initialized cache; the
    port writes the slot in place, which gives the same values because the
    free space is zero.  Returns ``cache`` (updated in place)."""
    cache[:, :, pos] = new
    return cache


# ---------------------------- serving ---------------------------------- #
def prefill(params, tokens, cfg: TransformerConfig,
            attn_backend: Optional[str] = None):
    """Run the prompt, return (kv_cache, last-token logits).

    kv cache: dict of k/v stacked [L, B, Hkv, S, D].  ``attn_backend`` is
    :func:`~repro_torch.models.attention.attention`'s ``backend``."""
    x = params["embed"][tokens.long()].to(cfg.cdtype)
    x, ks, vs = _layers(params, x, cfg, attn_backend)
    logits = (x[:, -1] @ _unembed(params)).float()
    return {"k": torch.stack(ks), "v": torch.stack(vs)}, logits


def decode_step(params, token, kv, pos: int, cfg: TransformerConfig):
    """One token for the whole batch against a full KV cache.

    token: int [B]; kv: {"k","v": [L, B, Hkv, S, D]}, updated in place;
    pos: current length.  Returns (logits [B, V], kv)."""
    x = _decode_layers(params, token, kv, pos, cfg)
    return (x[:, 0] @ _unembed(params)).float(), kv


def _decode_layers(params, token, kv, pos: int, cfg: TransformerConfig,
                   ffn=_dense_ffn):
    """Every layer for one token a row: the final-normed hidden states
    [B, 1, d]; ``kv`` is written in place at ``pos``."""
    b = token.shape[0]
    x = params["embed"][token.long()].to(cfg.cdtype)[:, None, :]
    smax = kv["k"].shape[3]
    cos, sin = L.rope_freqs(cfg.head_dim, smax, cfg.rope_theta, x.device)
    positions = torch.full((1,), pos, dtype=torch.long, device=x.device)
    for i, lp in enumerate(params["layers"]):
        q, k, v = _qkv(lp, x, cfg, positions, cos, sin)
        kc = cache_update_add(kv["k"][i], k[:, :, 0], pos)
        vc = cache_update_add(kv["v"][i], v[:, :, 0], pos)
        o = decode_ref(q[:, :, 0], kc, vc, pos + 1, window=cfg.local_window)
        x = _mix(lp, x, o.reshape(b, cfg.n_heads, 1, cfg.head_dim), cfg, ffn)
    return L.rmsnorm(x, params["ln_f"])

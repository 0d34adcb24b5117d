"""Mixture-of-Experts transformer (grok-1-314b, qwen2-moe-a2.7b).

The reference's ``models/moe.py``: the dense model's
attention (:mod:`repro_torch.models.transformer`'s layer loops, so K3 on
the card) with a routed feed-forward.  The router takes a softmax top-k
over the experts; the dispatch is sort-based with a per-group capacity,
as the reference's: tokens are regrouped ``[G, T/G, d]``, each group sorts
its (token, expert) pairs by expert, keeps the first ``C`` of each expert
and drops the rest, the experts run as batched matmuls, and the outputs
are combined with the normalized gates.

Where the reference vmaps one group at a time, the port runs all G groups
in one set of tensor operations, with the expert buffer laid out
``[E, G*C, d]`` so each expert product is one ``torch.bmm``.  The
reference's semantics are kept bit for bit where they are discrete:

* top-k breaks ties towards the lower expert index (``lax.top_k``'s order;
  ``torch.topk`` promises none), by a stable descending sort;
* the sort by expert is stable (``jnp.argsort``'s default);
* the combine adds each token's contributions in ascending expert order,
  rounding in the compute dtype after each add, as XLA's scatter-add does
  with the expert-sorted updates; no atomics, so it is deterministic on
  the card too.

The router and expert weights are cast to the compute dtype at each use,
as the dense model's matmul weights are: :func:`init` holds them in the
compute dtype for serving, :func:`init_master` in float32 for training.
The dispatch is differentiable: its gathers, index writes and
``torch.bmm``s carry gradients to the tokens, gates and expert weights,
and the aux loss carries them to the router.

Over a mesh, ``acts["moe_shard"]`` (:mod:`repro_torch.distributed.actshard`)
takes the reference's expert-TP branch (:func:`_moe_shard_ffn`): token
groups over the dp axes, each expert's FFN hidden dimension a local shard
over ``"model"``, one sum over ``"model"`` combining the down-projection
partials, the aux loss averaged over the token axes.

Functional API:
    params = init(generator, cfg)                  serving dtypes
    params = init_master(generator, cfg)           float32 masters
    x, aux = layer_fwd(lp, x, cfg, cos, sin)       one layer
    logits, aux = forward(params, tokens, cfg)     [B, S, V], scalar
    x, aux = forward_hidden(params, tokens, cfg)   [B, S, d], scalar
    loss = loss_fn(params, batch, cfg)             LM loss + aux
    kv, logits = prefill(params, tokens, cfg)
    logits, kv = decode_step(params, token, kv, pos, cfg)
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.actshard import constrain, is_dtensor
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

#: per-layer MoE weights used in matmuls (held in the compute dtype)
MOE_WEIGHTS = ("router", "we_gate", "we_up", "we_down", "ws_gate", "ws_up", "ws_down")


@dataclasses.dataclass(frozen=True)
class MoEConfig(T.TransformerConfig):
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    n_shared_experts: int = 0
    d_ff_shared: int = 0  # width of the fused shared-expert SwiGLU
    router_aux_coef: float = 0.01
    pad_experts_to: Optional[int] = None  # experts padded (never routed to)
    # tokens are dispatched in groups of T / G, each with its own capacity
    dispatch_groups: int = 512

    @property
    def n_experts_padded(self) -> int:
        return self.pad_experts_to or self.n_experts

    def _count(self, experts: int) -> int:
        """Parameters with ``experts`` expert FFNs a layer (the reference's
        count: the router's unpadded columns, no pad experts)."""
        d, f, v, l = self.d_model, self.d_ff, self.vocab, self.n_layers
        hd = self.head_dim
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) + (self.n_heads * hd) * d
        moe = 3 * d * f * experts + d * self.n_experts
        shared = 3 * d * self.d_ff_shared if self.n_shared_experts else 0
        per_layer = attn + moe + shared + 2 * d
        emb = v * d * (1 if self.tie_embeddings else 2)
        return l * per_layer + emb + d

    def n_params(self) -> int:
        return self._count(self.n_experts)

    def n_active_params(self) -> int:
        return self._count(self.top_k)


def port_dtype(name: str, cfg: MoEConfig) -> torch.dtype:
    """The dtype the port holds param ``name`` in: the compute dtype for
    every matmul weight, the param dtype for the norm gains."""
    return cfg.cdtype if name in MOE_WEIGHTS else T.port_dtype(name, cfg)


def layer_init(generator: torch.Generator, cfg: MoEConfig, dtype_of=port_dtype):
    d, hd, f, ep = cfg.d_model, cfg.head_dim, cfg.d_ff, cfg.n_experts_padded
    dev = generator.device

    def dense(name, d_in, d_out, scale=None):
        return L.dense_init(generator, d_in, d_out, dtype_of(name, cfg), scale)

    def experts(name, d_in, d_out):
        w = torch.randn((ep, d_in, d_out), generator=generator, dtype=torch.float32,
                        device=dev)
        return (w * d_in ** -0.5).to(dtype_of(name, cfg))

    p = {
        "ln1": L.rmsnorm_init(d, cfg.pdtype, dev),
        "ln2": L.rmsnorm_init(d, cfg.pdtype, dev),
        "wq": dense("wq", d, cfg.n_heads * hd),
        "wk": dense("wk", d, cfg.n_kv_heads * hd),
        "wv": dense("wv", d, cfg.n_kv_heads * hd),
        "wo": dense("wo", cfg.n_heads * hd, d),
        "router": dense("router", d, ep, scale=0.02),
        "we_gate": experts("we_gate", d, f),
        "we_up": experts("we_up", d, f),
        "we_down": experts("we_down", f, d),
    }
    if cfg.n_shared_experts:
        p["ws_gate"] = dense("ws_gate", d, cfg.d_ff_shared)
        p["ws_up"] = dense("ws_up", d, cfg.d_ff_shared)
        p["ws_down"] = dense("ws_down", cfg.d_ff_shared, d)
    return p


def init(generator: torch.Generator, cfg: MoEConfig, dtype_of=port_dtype):
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


def init_master(generator: torch.Generator, cfg: MoEConfig):
    """:func:`init`'s draws with every param in the param dtype: the
    float32 masters training updates."""
    return init(generator, cfg, T.master_dtype)


# ---------------------------- dispatch --------------------------------- #
def _segment_positions(sorted_ids):
    """Position of each element within its run of equal ids, along the last
    axis of ``sorted_ids`` (sorted along it)."""
    n = sorted_ids.shape[-1]
    idx = torch.arange(n, device=sorted_ids.device).expand_as(sorted_ids)
    is_start = torch.ones_like(sorted_ids, dtype=torch.bool)
    is_start[..., 1:] = sorted_ids[..., 1:] != sorted_ids[..., :-1]
    run_start = torch.where(is_start, idx, 0).cummax(dim=-1).values
    return idx - run_start


def _route(xt, router, cfg: MoEConfig, experts=None):
    """The router of every group: ``xt`` [G, t, d] -> (experts [G, t, K]
    int64, largest probability first; their gates, float32, normalized to
    sum 1; the Switch load-balance value of each group [G]).  ``experts``,
    when given, stands in for the top-k choice (the checks replay one
    run's routing in another, so the two differ by rounding alone)."""
    ep = cfg.n_experts_padded
    logits = (xt @ router.to(xt.dtype)).float()
    if ep != cfg.n_experts:  # padded experts are never routed to
        pad = torch.arange(ep, device=xt.device) >= cfg.n_experts
        logits = logits.masked_fill(pad, -1e30)
    probs = torch.softmax(logits, dim=-1)
    if experts is None:
        gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        gate_vals, gate_idx = gate_vals[..., :cfg.top_k], gate_idx[..., :cfg.top_k]
    else:
        gate_idx, gate_vals = experts, probs.gather(-1, experts)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    me = probs.mean(dim=1)
    ce = F.one_hot(gate_idx[..., 0], ep).float().mean(dim=1)
    aux = cfg.router_aux_coef * ep * (me * ce).sum(dim=-1)
    return gate_idx, gate_vals, aux


def router_gap_steps(logits, k: int, dtype: torch.dtype):
    """How near each token's top-k is to a tie: the gap between its k-th
    and (k+1)-th largest router logits (``logits`` [..., E], float32
    holding values rounded to ``dtype``, the compute dtype) in rounding
    steps of ``dtype`` at the larger magnitude of the two.  0 is an exact
    tie; at most 1, a tie that one rounding step of a logit can flip."""
    top = logits.float().topk(k + 1, dim=-1).values
    a, b = top[..., k - 1], top[..., k]
    mag = torch.maximum(a.abs(), b.abs()).clamp_min(torch.finfo(torch.float32).tiny)
    return (a - b) / (torch.finfo(dtype).eps * torch.exp2(torch.floor(torch.log2(mag))))


def route_flips(logits, experts, other_logits, other_experts, b: int) -> dict:
    """Where two runs of the same layers over the same ``b`` rows of tokens
    routed a token to another expert set, and whether each such flip was a
    near tie.  ``logits`` [L, T, E] float32 and ``experts`` [L, T, K] are
    run one's router logits and choices at every layer (T = b * s tokens in
    row order), ``other_*`` run two's.  Returns, as tensors:

    * ``differ`` [L, b, s]: the token's expert set differs at that layer;
    * ``clean`` [b, s]: no token at or before it in its row differs at any
      layer (what reaches a position through attention; a dispatch group
      within a row reaches it through capacity too);
    * ``gap`` [L, b, s]: run one's gap between the k-th and (k+1)-th logit;
    * ``drift`` [L]: the largest router-logit difference between the runs
      at that layer over the tokens whose row is clean before it and which
      did not flip there (0 where there are none);
    * ``first_flips``: for each row that flips, its first such layer's
      flipped tokens as (layer, row, position, gap, gap over twice the
      layer's drift).  A flip is a near tie when that ratio is at most 1:
      the gap is within what the two logits moved at that layer by the
      runs' rounding alone."""
    n_layers, t, k = experts.shape
    s = t // b
    differ = (experts.sort(-1).values != other_experts.sort(-1).values).any(-1)
    differ = differ.reshape(n_layers, b, s)
    top = logits.float().topk(k + 1, dim=-1).values
    gap = (top[..., k - 1] - top[..., k]).reshape(n_layers, b, s)
    moved = (logits.float() - other_logits.float()).abs().amax(-1).reshape(n_layers, b, s)
    before = torch.zeros((b, s), dtype=torch.bool, device=differ.device)
    drift = torch.zeros(n_layers, device=differ.device)
    for layer in range(n_layers):
        calm = ~before.cumsum(-1).bool() & ~differ[layer]
        drift[layer] = moved[layer][calm].max() if calm.any() else 0.0
        before |= differ[layer]
    first_flips = []
    for row in range(b):
        layers = differ[:, row].any(-1).nonzero().flatten().tolist()
        if layers:
            for pos in differ[layers[0], row].nonzero().flatten().tolist():
                g = float(gap[layers[0], row, pos])
                first_flips.append((layers[0], row, pos, g,
                                    g / max(2 * float(drift[layers[0]]), 1e-30)))
    return {"differ": differ, "clean": ~differ.any(0).cumsum(-1).bool(),
            "gap": gap, "drift": drift, "first_flips": first_flips}


def capacity(t: int, cfg: MoEConfig) -> int:
    """Slots each expert has in a group of ``t`` tokens (taken with the
    unpadded expert count, as the reference takes it)."""
    return int(cfg.capacity_factor * t * cfg.top_k / cfg.n_experts) + 1


def _slots(gate_idx, cap: int, ep: int):
    """Each (token, choice)'s row in the ``[E, G*C]`` expert buffer, shape
    [G, t, K]: group g's c-th token of expert e sits at row
    ``e*G*C + g*C + c``; a choice past its expert's capacity in its group
    gets ``E*G*C``, the sink.  Within an expert, tokens keep their order."""
    g, t, k = gate_idx.shape
    flat = gate_idx.reshape(g, t * k)
    order = torch.argsort(flat, dim=-1, stable=True)
    se = flat.gather(1, order)
    pos = _segment_positions(se)
    base = torch.arange(g, device=flat.device)[:, None] * cap
    slot = torch.where(pos < cap, se * (g * cap) + base + pos, ep * g * cap)
    return torch.empty_like(slot).scatter_(1, order, slot).reshape(g, t, k)


def _silu(h):
    """``jax.nn.silu`` as the reference's XLA evaluates it in ``h``'s dtype:
    ``h * (1 / (1 + exp(-h)))``, rounding after each step.  ``F.silu``
    rounds once, which in bf16 moves a third of the outputs by a step, and
    a step in an expert's output can flip a later layer's top-k."""
    return h * torch.reciprocal(torch.exp(-h) + 1)


def _dispatch(xt, lp, cfg: MoEConfig):
    """One MoE feed-forward over every group: ``xt`` [G, t, d] -> (out
    [G, t, d] in the compute dtype, aux [G])."""
    g, t, d = xt.shape
    ep, k = cfg.n_experts_padded, cfg.top_k
    gate_idx, gate_vals, aux = _route(xt, lp["router"], cfg)
    cap = capacity(t, cfg)
    rows = ep * g * cap
    slot = _slots(gate_idx, cap, ep)
    buf = xt.new_zeros((rows + 1, d))
    tok = torch.arange(g * t * k, device=xt.device) // k
    buf[slot.reshape(-1)] = xt.reshape(g * t, d)[tok]  # duplicates only at the sink
    buf = buf[:rows].view(ep, g * cap, d)
    cd = xt.dtype
    h = torch.bmm(buf, lp["we_gate"].to(cd))
    u = torch.bmm(buf, lp["we_up"].to(cd))
    y = torch.bmm(_silu(h) * u, lp["we_down"].to(cd)).view(rows, d)
    # each token's choices in ascending expert order, added one at a time
    by_expert = gate_idx.argsort(dim=-1)
    slot = slot.gather(2, by_expert)
    gate = gate_vals.gather(2, by_expert).to(xt.dtype)
    out = xt.new_zeros((g, t, d))
    for j in range(k):
        s = slot[..., j]
        contrib = torch.where((s < rows)[..., None], y[s.clamp(max=rows - 1)], 0)
        out = out + contrib * gate[..., j, None]
    if cfg.n_shared_experts:
        out = out + ((_silu(xt @ lp["ws_gate"].to(cd)) * (xt @ lp["ws_up"].to(cd)))
                     @ lp["ws_down"].to(cd))
    return out, aux


def group_count(t: int, cfg: MoEConfig) -> int:
    """The reference's group count for ``t`` tokens: ``dispatch_groups``,
    or fewer, lowered until it divides ``t``."""
    g = min(cfg.dispatch_groups, t)
    while t % g:
        g -= 1
    return g


def moe_ffn(lp, x, cfg: MoEConfig, acts=None):
    """x: [B, S, d] -> ([B, S, d], aux scalar): the group-local dispatch
    over ``dispatch_groups`` groups of consecutive tokens; with
    ``acts["moe_shard"]``, the expert-TP branch."""
    moe_shard = acts.get("moe_shard") if acts else None
    if moe_shard is not None:
        return _moe_shard_ffn(lp, x, cfg, moe_shard)
    b, s, d = x.shape
    g = group_count(b * s, cfg)
    out, aux = _dispatch(x.reshape(g, b * s // g, d), lp, cfg)
    return out.reshape(b, s, d), aux.mean()


def _local_groups(xl, weights: dict, cfg: MoEConfig, n_groups: int):
    """The dispatch of one rank's ``n_groups`` groups, one group at a time
    (the reference's scan), each under ``torch.utils.checkpoint`` in
    training so the backward recomputes one group's buffers at a time.
    Returns the FFN's output (a partial sum when ``weights`` hold an FFN
    shard) and the mean of the groups' aux."""
    b, s, d = xl.shape
    xt = xl.reshape(n_groups, b * s // n_groups, d)

    def one(xg):
        out, aux = _dispatch(xg[None], weights, cfg)
        return out[0], aux[0]

    outs, auxes = [], []
    for xg in xt.unbind(0):  # its backward stacks the groups' gradients once
        if torch.is_grad_enabled():
            out, aux = checkpoint(one, xg, use_reentrant=False)
        else:
            out, aux = one(xg)
        outs.append(out)
        auxes.append(aux)
    return torch.stack(outs).reshape(b, s, d), torch.stack(auxes).mean()


def _moe_shard_ffn(lp, x, cfg: MoEConfig, moe_shard):
    """The reference's ``shard_map`` branch.  ``moe_shard = (mesh, token
    axes, tp axis)``.  Token groups are split over the token axes and
    replicated over ``tp``; the router is replicated; each rank holds the
    ``tp`` shard of every expert's (and the shared experts') FFN hidden
    dimension, so its output is a partial sum, and one all-reduce over
    ``tp`` combines them.  The aux loss is each rank's mean over its groups,
    averaged over the token axes (not over ``tp``: every ``tp`` rank has the
    same groups).  On plain tensors (a mesh of one device) it is the same
    loop with no collective.  The reference has no all-to-all, and neither
    has this."""
    mesh, token_axes, tp = moe_shard
    b, s, d = x.shape
    g = group_count(b * s, cfg)
    names = ["router", "we_gate", "we_up", "we_down"]
    if cfg.n_shared_experts:
        names += ["ws_gate", "ws_up", "ws_down"]
    if not is_dtensor(x):
        return _local_groups(x, {n: lp[n] for n in names}, cfg, g)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    dims = tuple(x.device_mesh.mesh_dim_names)
    ntok = 1
    for a in token_axes:
        ntok *= x.device_mesh.size(dims.index(a))
    if g % ntok or b % ntok:
        raise ValueError(f"{g} dispatch groups of {b} rows do not split over "
                         f"{ntok} token shards")

    def pl(tok, model):
        return [tok if n in token_axes else model if n == tp else Replicate()
                for n in dims]

    # the tp shard of each FFN's hidden dimension: we_* [E, d, ff] and
    # [E, ff, d], ws_* [d, F] and [F, d]
    ff_dim = {"router": None, "we_gate": 2, "we_up": 2, "we_down": 1,
              "ws_gate": 1, "ws_up": 1, "ws_down": 0}
    w_pl = [pl(Replicate(), Replicate() if ff_dim[n] is None else Shard(ff_dim[n]))
            for n in names]
    x_pl = pl(Shard(0), Replicate())
    ws = [lp[n].redistribute(x.device_mesh, p) for n, p in zip(names, w_pl)]
    # Each rank differentiates its own tokens through its own FFN shard, so
    # the gradients it returns are partial sums: over the token axes for
    # every weight, over tp for the tokens and the router (each tp rank
    # reaches them through its shard only).  The aux loss, computed alike
    # on every tp rank, enters the sum once: each rank returns its share.
    g_pl = [pl(Partial(), Partial() if ff_dim[n] is None else Shard(ff_dim[n]))
            for n in names]
    ntp = x.device_mesh.size(dims.index(tp))

    def body(xl, *wl):
        out, aux = _local_groups(xl, dict(zip(names, wl)), cfg, g // ntok)
        return out, aux / (ntok * ntp)

    out, aux = local_map(body, out_placements=(pl(Shard(0), Partial()),
                                               pl(Partial(), Partial())),
                         in_placements=(x_pl, *w_pl),
                         in_grad_placements=(pl(Shard(0), Partial()), *g_pl),
                         device_mesh=x.device_mesh)(
        x.redistribute(x.device_mesh, x_pl), *ws)
    rep = [Replicate()] * len(dims)
    return (out.redistribute(x.device_mesh, pl(Shard(0), Replicate())),
            aux.redistribute(x.device_mesh, rep))



def _ffn(cfg: MoEConfig, acts, auxes: list):
    """The layer loops' feed-forward: :func:`moe_ffn`, its aux appended to
    ``auxes``."""
    def ffn(lp, xn):
        y, aux = moe_ffn(lp, xn, cfg, acts)
        auxes.append(aux)
        return y
    return ffn


def layer_fwd(lp, x, cfg: MoEConfig, cos, sin, positions=None,
              attn_backend: Optional[str] = None, acts=None):
    """One layer over ``x`` [B, S, d]: (the layer's output, its aux)."""
    q, k, v = T._qkv(lp, x, cfg, positions, cos, sin)
    o = T.attention(q, k, v, causal=True, local_window=cfg.local_window,
                    backend=attn_backend, q_chunk=cfg.attn_q_chunk,
                    kv_chunk=cfg.attn_kv_chunk)
    auxes = []
    return T._mix(lp, x, o, cfg, _ffn(cfg, acts, auxes)), auxes[0]


def forward(params, tokens, cfg: MoEConfig, attn_backend: Optional[str] = None,
            acts=None):
    """tokens: int [B, S] -> (logits float32 [B, S, V], the layers' aux
    summed)."""
    x = constrain(T.embed(params, tokens, cfg), acts, "res")
    cos, sin = L.rope_freqs(cfg.head_dim, x.shape[1], cfg.rope_theta, x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in params["layers"]:  # aux in layer order, as the reference's scan carries it
        x, a = layer_fwd(lp, x, cfg, cos, sin, attn_backend=attn_backend, acts=acts)
        x = constrain(x, acts, "res")
        aux = aux + a
    x = L.rmsnorm(x, params["ln_f"])
    return constrain((x @ T._unembed(params, cfg)).float(), acts, "logits"), aux


def forward_hidden(params, tokens, cfg: MoEConfig, attn_backend: Optional[str] = None,
                   acts=None):
    """tokens -> (final hidden states [B, S, d], the layers' aux summed in
    layer order); each layer under ``torch.utils.checkpoint`` in training
    when ``cfg.remat`` is set."""
    x = constrain(T.embed(params, tokens, cfg), acts, "res")
    cos, sin = L.rope_freqs(cfg.head_dim, tokens.shape[1], cfg.rope_theta, x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def layer(lp, x, cfg, cos, sin, positions=None, attn_backend=None):
        return layer_fwd(lp, x, cfg, cos, sin, positions, attn_backend, acts)

    for lp in params["layers"]:
        x, a = T.run_layer(layer, lp, x, cfg, cos, sin, attn_backend)
        x = constrain(x, acts, "res")
        aux = aux + a
    return L.rmsnorm(x, params["ln_f"]), aux


def loss_fn(params, batch, cfg: MoEConfig, attn_backend: Optional[str] = None, acts=None):
    """The dense model's next-token loss plus the layers' load-balance aux."""
    x, aux = forward_hidden(params, batch["tokens"], cfg, attn_backend, acts)
    return L.lm_loss_fused(x[:, :-1], T._unembed(params, cfg), batch["labels"][:, 1:],
                           cfg.z_loss, acts=acts) + aux


# ---------------------------- serving ---------------------------------- #
def prefill(params, tokens, cfg: MoEConfig, attn_backend: Optional[str] = None,
            acts=None):
    """Run the prompt, return (kv_cache, last-token logits); kv stacked
    [L, B, Hkv, S, D], as :func:`repro_torch.models.transformer.prefill`."""
    x, ks, vs = T._layers(params, T.embed(params, tokens, cfg), cfg, attn_backend,
                          _ffn(cfg, acts, []), acts)
    logits = constrain((x[:, -1] @ T._unembed(params, cfg)).float(), acts, "logits")
    return {"k": torch.stack(ks), "v": torch.stack(vs)}, logits


def decode_step(params, token, kv, pos: int, cfg: MoEConfig, acts=None):
    """One token for the whole batch against a full KV cache (updated in
    place): (logits [B, V], kv).  Each token is a dispatch group of its
    own (B <= ``dispatch_groups``), so every expert's weights are read every
    step (capacity 1), as in the reference."""
    x = T._decode_layers(params, token, kv, pos, cfg, _ffn(cfg, acts, []), acts)
    return constrain((x[:, 0] @ T._unembed(params, cfg)).float(), acts, "logits"), kv

"""GNN zoo on the segment-reduce substrate: GCN, GraphSAGE, GAT and
MeshGraphNet, and the paper's k-hop window sum as a feature operator.

Message passing is the paper's own primitive: gather rows by edge, reduce
them into the destination.  The reference runs it on
``jax.ops.segment_sum`` / ``segment_max``; the port runs it on K1 (the
fused gather + tiled segment reduction, ``kernels/segment_reduce``)
through an :class:`EdgePlan`, one K1 tile plan per graph built once on the
host from the destination-sorted edges.  K1 adds in an order fixed by the
plan, so two forwards on the card are bitwise equal, which
``index_add_``'s float atomics cannot promise.

Inputs keep the reference's padded edge lists (edges sorted by
destination, padding edges pointing at the sink row ``n``); in the plan a
padding edge reaches no segment, where the reference zeroes its message.

K1 launches per forward on the card: GCN and GraphSAGE one a layer;
MeshGraphNet one a processor step; GAT three a layer (the softmax's max,
its denominator, the weighted messages: each needs the one before);
:func:`khop_aggregate` two (the DBIndex's two passes, ``D`` columns wide).
Matmuls stay ``torch.matmul`` in float32 (TF32 off, as PyTorch defaults).

``node_spec`` and ``remat_chunk`` are the reference's sharding constraint
and backward checkpointing hints.  A forward on one card has no use for
either: they are accepted with the reference's defaults and do nothing.
Params are nested dicts of tensors; MeshGraphNet's processor steps are a
list of per-step dicts (the reference stacks them for ``lax.scan``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device, upload
from repro_torch.kernels.segment_reduce.ops import (
    TilePlan,
    build_tile_plan,
    segment_reduce_multi,
)
from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    kind: str  # gcn | gat | sage | meshgraphnet
    n_layers: int
    d_in: int
    d_hidden: int
    d_out: int
    n_heads: int = 1
    aggregator: str = "mean"  # mean | sum | attn
    mlp_layers: int = 2
    param_dtype: str = "float32"
    compute_dtype: str = "float32"

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


# ------------------------- the graph's K1 plan ------------------------- #
@dataclasses.dataclass(frozen=True)
class EdgePlan:
    """One graph's K1 tile plans: the valid edges (``dst < n``) grouped by
    destination, in edge order within a destination.  ``by_edge`` gathers
    per-edge rows by edge id (GCN's weighted messages, GAT's scores and
    messages, MeshGraphNet's edge states); ``by_src`` gathers node rows by
    the edge's source (GraphSAGE), sharing ``by_edge``'s segment layout.
    ``in_degree`` counts each node's valid incoming edges (host-exact)."""

    n: int
    by_edge: TilePlan
    by_src: TilePlan
    in_degree: torch.Tensor  # f32 [n]

    def plan_nbytes(self) -> int:
        return (self.by_edge.plan_nbytes() + int(self.by_src.gather_padded.nbytes)
                + int(self.in_degree.nbytes))


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def edge_plan(edge_src, edge_dst, n: int, torch_device="cuda") -> EdgePlan:
    """Build the :class:`EdgePlan` of a padded edge list on the host (NumPy)
    and upload it to ``torch_device``.  ``edge_src`` may be ``None`` when
    only per-edge rows are reduced (``by_src`` then gathers row 0)."""
    dev = resolve_device(torch_device)
    dst = _host(edge_dst).astype(np.int64)
    order = np.argsort(dst, kind="stable")
    keep = order[dst[order] < n]
    by_edge = build_tile_plan(keep, dst[keep], n, torch_device=dev)
    if edge_src is None:
        src_rows = np.zeros(max(dst.size, 1), np.int32)
    else:
        src_rows = np.minimum(_host(edge_src), n - 1).astype(np.int32)
    src_t = upload(src_rows, dev)
    by_src = dataclasses.replace(
        by_edge, gather_padded=src_t[by_edge.gather_padded.long()].contiguous())
    deg = np.bincount(dst[keep], minlength=n).astype(np.float32)
    return EdgePlan(n=int(n), by_edge=by_edge, by_src=by_src,
                    in_degree=upload(deg, dev, np.float32))


def _plan_for(plan: Optional[EdgePlan], edge_src, dst, n, dev) -> EdgePlan:
    return plan if plan is not None else edge_plan(edge_src, dst, n, torch_device=dev)


def _cols(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1)


# ------------------------- message passing ----------------------------- #
def scatter_sum(messages, dst, n, plan: Optional[EdgePlan] = None):
    """Per-edge ``messages`` ``[E, ...]`` summed into their destination:
    ``[n, ...]`` float32, one K1 launch (edges with ``dst >= n`` reach no
    node)."""
    plan = _plan_for(plan, None, dst, n, messages.device)
    out = segment_reduce_multi(plan.by_edge, _cols(messages),
                               (_cols(messages).shape[1], 0, 0))
    return out.reshape((n,) + tuple(messages.shape[1:]))


def scatter_mean(messages, dst, n, plan: Optional[EdgePlan] = None):
    """:func:`scatter_sum` over each node's incoming edge count (at least
    1), as the reference's ``s / max(cnt, 1)``."""
    plan = _plan_for(plan, None, dst, n, messages.device)
    s = scatter_sum(messages, dst, n, plan)
    return s / torch.clamp(plan.in_degree, min=1.0)[:, None]


def edge_softmax(scores, dst, n, plan: Optional[EdgePlan] = None):
    """scores ``[E, H]`` -> softmax over each node's incoming edges, per
    head: K1's max monoid (``-inf`` in an empty segment, as
    ``jax.ops.segment_max`` before ``nan_to_num``), then K1's sum of the
    exponentials."""
    plan = _plan_for(plan, None, dst, n, scores.device)
    ed = torch.clamp(torch.as_tensor(dst, device=scores.device), max=n - 1).long()
    h = scores.shape[1]
    m = segment_reduce_multi(plan.by_edge, scores, (0, 0, h))
    m = torch.nan_to_num(m[ed], neginf=0.0)
    e = torch.exp(scores - m)
    z = segment_reduce_multi(plan.by_edge, e, (h, 0, 0))[ed]
    return e / torch.clamp(z, min=1e-16)


def _edges(edge_src, edge_dst, n, dev):
    """(sources, destinations) clamped into ``[0, n)`` as int64 on ``dev``,
    the rows the reference's ``jnp.take`` reads."""
    es = torch.clamp(torch.as_tensor(edge_src, device=dev), max=n - 1).long()
    ed = torch.clamp(torch.as_tensor(edge_dst, device=dev), max=n - 1).long()
    return es, ed


# ------------------------------ models --------------------------------- #
def _dims(cfg: GNNConfig):
    return [cfg.d_in] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.d_out]


def gcn_init(generator: torch.Generator, cfg: GNNConfig):
    d = _dims(cfg)
    return {"w": [L.dense_init(generator, a, b, cfg.pdtype) for a, b in zip(d[:-1], d[1:])]}


def gcn_forward(params, feats, edge_src, edge_dst, edge_w, n, cfg: GNNConfig,
                node_spec=None, plan: Optional[EdgePlan] = None):
    """Sym-normalized GCN.  edge_w = 1/sqrt(deg_s * deg_d) precomputed."""
    dev = feats.device
    plan = _plan_for(plan, edge_src, edge_dst, n, dev)
    es, _ = _edges(edge_src, edge_dst, n, dev)
    w_e = torch.as_tensor(edge_w, device=dev).to(cfg.cdtype)[:, None]
    h = feats.to(cfg.cdtype)
    for i, w in enumerate(params["w"]):
        agg = scatter_sum(h[es] * w_e, edge_dst, n, plan)
        h = agg @ w.to(cfg.cdtype)
        if i < len(params["w"]) - 1:
            h = F.relu(h)
    return h


def sage_init(generator: torch.Generator, cfg: GNNConfig):
    d = _dims(cfg)
    w_self, w_nbr = [], []
    for a, b in zip(d[:-1], d[1:]):
        w_self.append(L.dense_init(generator, a, b, cfg.pdtype))
        w_nbr.append(L.dense_init(generator, a, b, cfg.pdtype))
    return {"w_self": w_self, "w_nbr": w_nbr}


def sage_forward(params, feats, edge_src, edge_dst, n, cfg: GNNConfig,
                 node_spec=None, plan: Optional[EdgePlan] = None):
    """GraphSAGE, mean aggregator: K1 gathers the source nodes' rows
    itself (``by_src``), one launch a layer."""
    plan = _plan_for(plan, edge_src, edge_dst, n, feats.device)
    deg = torch.clamp(plan.in_degree, min=1.0)[:, None]
    h = feats.to(cfg.cdtype)
    for i, (ws, wn) in enumerate(zip(params["w_self"], params["w_nbr"])):
        agg = segment_reduce_multi(plan.by_src, h, (h.shape[1], 0, 0)) / deg
        h = h @ ws.to(cfg.cdtype) + agg @ wn.to(cfg.cdtype)
        if i < len(params["w_self"]) - 1:
            h = F.relu(h)
    return h


def gat_init(generator: torch.Generator, cfg: GNNConfig):
    ws, al, ar = [], [], []
    d_in = cfg.d_in
    for i in range(cfg.n_layers):
        d_out = cfg.d_out if i == cfg.n_layers - 1 else cfg.d_hidden
        ws.append(L.dense_init(generator, d_in, cfg.n_heads * d_out, cfg.pdtype))
        al.append(L.dense_init(generator, d_out, cfg.n_heads, cfg.pdtype, scale=0.1))
        ar.append(L.dense_init(generator, d_out, cfg.n_heads, cfg.pdtype, scale=0.1))
        d_in = cfg.n_heads * d_out if i < cfg.n_layers - 1 else d_out
    return {"w": ws, "a_l": al, "a_r": ar}


def gat_forward(params, feats, edge_src, edge_dst, n, cfg: GNNConfig,
                node_spec=None, plan: Optional[EdgePlan] = None):
    dev = feats.device
    plan = _plan_for(plan, edge_src, edge_dst, n, dev)
    es, ed = _edges(edge_src, edge_dst, n, dev)
    h = feats.to(cfg.cdtype)
    nl = len(params["w"])
    for i in range(nl):
        d_out = cfg.d_out if i == nl - 1 else cfg.d_hidden
        hw = (h @ params["w"][i].to(cfg.cdtype)).reshape(n, cfg.n_heads, d_out)
        # a_l/a_r: [d_out, H] -> per-(node, head) scalars
        sl = torch.einsum("nhd,dh->nh", hw, params["a_l"][i].to(cfg.cdtype))
        sr = torch.einsum("nhd,dh->nh", hw, params["a_r"][i].to(cfg.cdtype))
        scores = F.leaky_relu(sl[es] + sr[ed], 0.2)
        alpha = edge_softmax(scores, edge_dst, n, plan)  # [E, H]
        agg = scatter_sum(hw[es] * alpha[..., None], edge_dst, n, plan)
        if i < nl - 1:
            h = F.elu(agg.reshape(n, cfg.n_heads * d_out))
        else:
            h = agg.mean(dim=1)
    return h


def mgn_init(generator: torch.Generator, cfg: GNNConfig, d_edge: int = 3):
    """MeshGraphNet: encoder/decoder MLPs and ``n_layers`` processor steps,
    a list of per-step dicts."""
    hid = cfg.d_hidden

    def mk(dims):
        return L.mlp_init(generator, dims, cfg.pdtype)

    node_enc = mk([cfg.d_in, hid, hid])
    edge_enc = mk([d_edge, hid, hid])
    proc = [{"edge_mlp": mk([3 * hid, hid, hid]), "node_mlp": mk([2 * hid, hid, hid])}
            for _ in range(cfg.n_layers)]
    return {"node_enc": node_enc, "edge_enc": edge_enc, "proc": proc,
            "node_dec": mk([hid, hid, cfg.d_out])}


def mgn_forward(params, feats, edge_feats, edge_src, edge_dst, n, cfg: GNNConfig,
                remat_chunk: int = 3, node_spec=None, plan: Optional[EdgePlan] = None):
    dev = feats.device
    plan = _plan_for(plan, edge_src, edge_dst, n, dev)
    es, ed = _edges(edge_src, edge_dst, n, dev)
    h = L.mlp_apply(params["node_enc"], feats.to(cfg.cdtype))
    e = L.mlp_apply(params["edge_enc"], edge_feats.to(cfg.cdtype))
    for lp in params["proc"]:
        inp = torch.cat([e, h[es], h[ed]], dim=-1)
        e = e + L.mlp_apply(lp["edge_mlp"], inp)
        agg = scatter_sum(e, edge_dst, n, plan)
        h = h + L.mlp_apply(lp["node_mlp"], torch.cat([h, agg], dim=-1))
    return L.mlp_apply(params["node_dec"], h)


# ---------------- paper-technique integration ------------------------- #
def khop_aggregate(plan, node_values):
    """k-hop window SUM of node features ``[n]`` or ``[n, D]`` via the
    DBIndex plan (:class:`~repro_torch.core.engine_torch.DBIndexPlan`): the
    paper's shared two-stage aggregation as a GNN feature operator, two K1
    launches whatever ``D``."""
    from repro_torch.core.engine_torch import query_dbindex

    return query_dbindex(plan, node_values, "sum")

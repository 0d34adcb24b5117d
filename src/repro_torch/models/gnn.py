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

Training: when autograd records, message passing goes through
``torch.autograd.Function``s whose backward is K1 again, over the edges
grouped by source (:meth:`EdgePlan.source`); no sum of the backward uses
atomics.  K1 launches in the backward, for a layer whose input needs a
gradient: GCN and GraphSAGE one a layer (none for the first, whose input
is the features), GAT four a layer (the gathers at the sources and at
the destinations of the scores, of the softmax's denominator and of the
messages), MeshGraphNet two a processor step.  An :class:`EdgePlan` with
a ``group`` holds one shard of the edges; node rows stay replicated
(``launch/steps.build_gnn_train``).

``node_spec`` and ``remat_chunk`` are the reference's sharding constraint
and backward checkpointing hints.  The port has no use for either (node
states are replicated; MeshGraphNet's activations at the molecule shape
need no recomputation): they are accepted with the reference's defaults
and do nothing.

Params are nested dicts of tensors; MeshGraphNet's processor steps are a
list of per-step dicts (the reference stacks them for ``lax.scan``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

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
    ``in_degree`` counts each node's valid incoming edges (host-exact).

    The backward of message passing reads the same edges grouped by
    source: :meth:`source` builds that layout from these plans on its first
    call and keeps it (serving never calls it).  ``group`` is the process
    group over which an edge shard's partial node sums combine (``None``:
    the plan holds every edge of the graph); ``in_degree`` then counts the
    whole graph's edges."""

    n: int
    by_edge: TilePlan
    by_src: TilePlan
    in_degree: torch.Tensor  # f32 [n]
    n_edges: int = 0  # the padded edge list's length
    group: Any = None
    _source: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    def plan_nbytes(self) -> int:
        return (self.by_edge.plan_nbytes() + int(self.by_src.gather_padded.nbytes)
                + int(self.in_degree.nbytes))

    def source(self) -> Tuple[TilePlan, TilePlan]:
        """``(by_src_edge, by_src_dst)``: the valid edges grouped by their
        (clamped) source node, in destination order within a source.
        ``by_src_edge`` gathers per-edge rows by edge id (the transpose of
        the gathers ``x[src]``); ``by_src_dst`` gathers node rows by the
        edge's destination (the transpose of ``by_src``), sharing
        ``by_src_edge``'s segment layout.  Built from the destination-sorted
        plans on the first call (sorted on their device, laid out on the
        host), then kept."""
        if "layouts" not in self._source:
            self._source["layouts"] = _source_layouts(self)
        return self._source["layouts"]

    def source_nbytes(self) -> int:
        """Device bytes of :meth:`source`'s layouts (0 until built)."""
        if "layouts" not in self._source:
            return 0
        by_src_edge, by_src_dst = self._source["layouts"]
        return by_src_edge.plan_nbytes() + int(by_src_dst.gather_padded.nbytes)


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
                    in_degree=upload(deg, dev, np.float32), n_edges=int(dst.size))


def _source_layouts(plan: EdgePlan) -> Tuple[TilePlan, TilePlan]:
    """:meth:`EdgePlan.source`: the valid plan rows of ``by_edge`` (edge
    id, destination) and ``by_src`` (source), sorted by source on the
    plan's device (a stable sort, so destination order within a source),
    laid out on the host by ``build_tile_plan``; ``by_src_dst``'s gather is
    each row's destination, looked up by its edge id on the device."""
    be = plan.by_edge
    seg = be.seg_tiles.reshape(-1)
    ok = seg >= 0
    eid, dst = be.gather_padded[ok], seg[ok]
    src, order = torch.sort(plan.by_src.gather_padded[ok], stable=True)
    by_src_edge = build_tile_plan(_host(eid[order]), _host(src), plan.n, be.tm, be.ts,
                                  torch_device=be.device)
    n_rows = max(plan.n_edges, int(eid.max()) + 1 if eid.numel() else 1)
    dst_of_edge = torch.zeros(n_rows, dtype=torch.int32, device=be.device)
    dst_of_edge[eid.long()] = dst
    by_src_dst = dataclasses.replace(
        by_src_edge,
        gather_padded=dst_of_edge[by_src_edge.gather_padded.long()].contiguous())
    return by_src_edge, by_src_dst


def _plan_for(plan: Optional[EdgePlan], edge_src, dst, n, dev) -> EdgePlan:
    return plan if plan is not None else edge_plan(edge_src, dst, n, torch_device=dev)


def _cols(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1)


def _sum_all(tp: TilePlan, x: torch.Tensor) -> torch.Tensor:
    """One K1 launch: every column of ``x`` a sum over ``tp``."""
    return segment_reduce_multi(tp, x, (x.shape[1], 0, 0))


def _record(*ts) -> bool:
    """Whether autograd records a call on ``ts``: message passing then goes
    through the Functions below, whose backward is K1 again."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


# ------------- message passing with K1 as its own backward ------------- #
# K1 sums rows ``values[gather[r]]`` into segment ``seg[r]``.  Its gradient
# with respect to ``values`` sums ``dout[seg[r]]`` into ``gather[r]`` over
# the same rows, grouped the other way: K1 again, over the source-sorted
# layout (``EdgePlan.source``).  K1 adds in an order fixed by its plan, so
# the backward repeats to the bit, where ``index_add_`` and the backward of
# ``x[idx]`` (both float atomics on the card) do not.  On the CPU the same
# Functions run with K1's plain version inside.  A padding edge
# (``dst >= n``) reaches no segment of either layout: its message reaches
# no node, so its gradient is zero in every model here (the reference masks
# it), and the backward leaves it out.
class _ScatterSum(torch.autograd.Function):
    """Per-edge rows ``[E, C]`` summed into their destination (K1 on
    ``by_edge``); backward: the gather ``dout[dst]``, 0 on padding edges."""

    @staticmethod
    def forward(ctx, messages, dst, plan):
        ctx.plan = plan
        ctx.save_for_backward(dst)
        return _sum_all(plan.by_edge, messages)

    @staticmethod
    def backward(ctx, dout):
        (dst,) = ctx.saved_tensors
        n = ctx.plan.n
        g = dout.index_select(0, torch.clamp(dst, max=n - 1).long())
        return torch.where((dst < n)[:, None], g, torch.zeros((), dtype=g.dtype,
                                                              device=g.device)), None, None


class _GatherRows(torch.autograd.Function):
    """Node rows ``x[idx]`` ``[E, C]`` (``index_select``) at the edges'
    sources (``by="src"``) or destinations (``by="dst"``); backward: K1 over
    ``by_src_edge`` or ``by_edge``, each node summing its edges' rows."""

    @staticmethod
    def forward(ctx, x, idx, plan, by):
        ctx.plan, ctx.by = plan, by
        return x.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        tp = ctx.plan.source()[0] if ctx.by == "src" else ctx.plan.by_edge
        return _sum_all(tp, g.contiguous()), None, None, None


class _SourceSum(torch.autograd.Function):
    """GraphSAGE's fused reduction: node rows summed by destination over
    their sources (K1 on ``by_src``); backward: one K1 on ``by_src_dst``,
    at the width of ``dout``."""

    @staticmethod
    def forward(ctx, h, plan):
        ctx.plan = plan
        return _sum_all(plan.by_src, h)

    @staticmethod
    def backward(ctx, dout):
        return _sum_all(ctx.plan.source()[1], dout.contiguous()), None


# Megatron's conjugate pair (f, g) for an edge shard (``EdgePlan.group``):
# replicated node rows enter the shard through f, the shard's partial node
# sums leave it through g.  Without a group both are the identity.
class _CopyToEdges(torch.autograd.Function):
    """f: identity forward, ``all_reduce`` (sum) of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        torch.distributed.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromEdges(torch.autograd.Function):
    """g: ``all_reduce`` (sum) forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        torch.distributed.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def _to_edges(x, plan: EdgePlan):
    return x if plan.group is None else _CopyToEdges.apply(x, plan.group)


def _from_edges(x, plan: EdgePlan):
    return x if plan.group is None else _ReduceFromEdges.apply(x, plan.group)


def _edge_params(tree, plan: EdgePlan):
    """Params the edge shard alone uses (MeshGraphNet's edge encoder and
    edge MLPs), through f: their gradients are summed across the shards."""
    if plan.group is None:
        return tree
    if isinstance(tree, dict):
        return {k: _edge_params(v, plan) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_edge_params(v, plan) for v in tree]
    return _to_edges(tree, plan)


def gather_rows(x, idx, plan: EdgePlan, by: str):
    """``x[idx]`` for node rows ``x`` ``[n, ...]`` and the edges' clamped
    sources (``by="src"``) or destinations (``by="dst"``) ``idx`` (int64)."""
    x = _to_edges(x, plan)
    flat = _cols(x)
    out = (_GatherRows.apply(flat, idx, plan, by) if _record(flat)
           else flat.index_select(0, idx))
    return out.reshape((idx.shape[0],) + tuple(x.shape[1:]))


def source_sum(h, plan: EdgePlan):
    """``[n, C]`` node rows summed into each node over its valid incoming
    edges' sources: one K1 launch on ``by_src``."""
    h = _to_edges(h, plan)
    out = _SourceSum.apply(h, plan) if _record(h) else _sum_all(plan.by_src, h)
    return _from_edges(out, plan)


def scatter_sum(messages, dst, n, plan: Optional[EdgePlan] = None):
    """Per-edge ``messages`` ``[E, ...]`` summed into their destination:
    ``[n, ...]`` float32, one K1 launch (edges with ``dst >= n`` reach no
    node)."""
    plan = _plan_for(plan, None, dst, n, messages.device)
    cols = _cols(messages)
    if _record(cols):
        out = _ScatterSum.apply(cols, torch.as_tensor(dst, device=cols.device), plan)
    else:
        out = _sum_all(plan.by_edge, cols)
    return _from_edges(out, plan).reshape((n,) + tuple(messages.shape[1:]))


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
    exponentials.

    The max is taken on detached scores: softmax is invariant to the shift,
    so the total gradient through it is zero (the reference differentiates
    through ``segment_max`` and gets that zero up to rounding).  An edge
    shard takes the max over every shard (``all_reduce`` MAX)."""
    plan = _plan_for(plan, None, dst, n, scores.device)
    ed = torch.clamp(torch.as_tensor(dst, device=scores.device), max=n - 1).long()
    h = scores.shape[1]
    m = segment_reduce_multi(plan.by_edge, scores.detach(), (0, 0, h))
    if plan.group is not None:
        torch.distributed.all_reduce(m, op=torch.distributed.ReduceOp.MAX, group=plan.group)
    m = torch.nan_to_num(m[ed], neginf=0.0)
    e = torch.exp(scores - m)
    z = gather_rows(scatter_sum(e, dst, n, plan), ed, plan, "dst")
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
        agg = scatter_sum(gather_rows(h, es, plan, "src") * w_e, edge_dst, n, plan)
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
    itself (``by_src``), one launch a layer (:func:`source_sum`)."""
    plan = _plan_for(plan, edge_src, edge_dst, n, feats.device)
    deg = torch.clamp(plan.in_degree, min=1.0)[:, None]
    h = feats.to(cfg.cdtype)
    for i, (ws, wn) in enumerate(zip(params["w_self"], params["w_nbr"])):
        agg = source_sum(h, plan) / deg
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
        scores = F.leaky_relu(gather_rows(sl, es, plan, "src")
                              + gather_rows(sr, ed, plan, "dst"), 0.2)
        alpha = edge_softmax(scores, edge_dst, n, plan)  # [E, H]
        agg = scatter_sum(gather_rows(hw, es, plan, "src") * alpha[..., None],
                          edge_dst, n, plan)
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
    e = L.mlp_apply(_edge_params(params["edge_enc"], plan), edge_feats.to(cfg.cdtype))
    for lp in params["proc"]:
        inp = torch.cat([e, gather_rows(h, es, plan, "src"),
                         gather_rows(h, ed, plan, "dst")], dim=-1)
        e = e + L.mlp_apply(_edge_params(lp["edge_mlp"], plan), inp)
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

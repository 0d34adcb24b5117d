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
messages), MeshGraphNet three a processor step (its two gathers, and the
recomputed forward's sum: see ``remat_chunk`` below).

An :class:`EdgePlan` with a ``group`` holds one shard of the edges, and
node rows shard over the same group, as the reference's ``node_spec``
shards node states over the edge spec's axes (:class:`NodeRows`): each
rank holds ``ceil(n / W)`` rows, all-gathers them where its edges read
them and reduce-scatters its partial node sums back into them
(Megatron's sequence-parallel pair); node-side matmuls and MLPs run on
the rank's rows only, and every parameter's gradient, a partial sum on
each rank, is all-reduced.  GAT's softmax statistics (the per-head max
and the denominator, ``[n, H]``) stay whole.  ``node_spec`` is the
reference's parameter, accepted and not read: the plan's group says the
same.

``remat_chunk``: MeshGraphNet's processor steps, when autograd records,
run under ``torch.utils.checkpoint`` in chunks of ``remat_chunk`` steps
(1 when it does not divide ``n_layers``), as the reference's nested
``jax.checkpoint``: the backward keeps only each chunk's input carries
and recomputes the chunk's forward, all-gathers included.

Params are nested dicts of tensors; MeshGraphNet's processor steps are a
list of per-step dicts (the reference stacks them for ``lax.scan``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device, upload
from repro_torch.kernels.segment_reduce.ops import (
    TilePlan,
    build_tile_plan,
    segment_reduce_multi,
)
from repro_torch.models import layers as L
from repro_torch.tree import leaves


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
    group of an edge shard, over which node rows shard too
    (:func:`node_rows`; ``None``: the plan holds every edge and every row
    of the graph); ``in_degree`` then counts the whole graph's edges."""

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


# Megatron's conjugate pair (f, g) over an edge shard's group
# (``EdgePlan.group``): f is the identity forward and sums the gradient
# across the shards backward (each parameter, and GAT's softmax
# denominator, which every shard reads whole), g sums across the shards
# forward (the denominator's partial sums, a loss's partial sums).
class _CopyToEdges(torch.autograd.Function):
    """f: identity forward, ``all_reduce`` (sum) of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        out = g.contiguous().clone()
        torch.distributed.all_reduce(out, group=ctx.group)
        # in ``g``'s layout: a sum over the gradient (the optimizer's norm)
        # runs in its memory order
        return torch.empty_like(g).copy_(out), None


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


def _shard_params(tree, plan: EdgePlan):
    """Every param through f: on an edge shard each acts on the rank's
    edges or node rows only, so its gradient is summed across the shards."""
    if plan.group is None:
        return tree
    if isinstance(tree, dict):
        return {k: _shard_params(v, plan) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shard_params(v, plan) for v in tree]
    return _CopyToEdges.apply(tree, plan.group)


# Node rows over an edge shard's group: Megatron's sequence-parallel pair.
# A rank's rows enter its edges through an all-gather (backward:
# reduce-scatter), its partial node sums leave them through a
# reduce-scatter (backward: all-gather).  Both collectives take equal
# chunks: the whole rows are padded to ``world * chunk`` with zero rows,
# which are cut off again before anything reads them.
@dataclasses.dataclass(frozen=True)
class NodeRows:
    """The node rows one rank owns on an edge shard: rank ``r`` of the
    group's ``world`` holds rows ``[r * chunk, (r + 1) * chunk)`` of
    ``[0, n)``, ``chunk = ceil(n / world)``."""

    n: int
    group: Any
    rank: int
    world: int

    @property
    def chunk(self) -> int:
        return -(-self.n // self.world)

    @property
    def lo(self) -> int:
        return min(self.rank * self.chunk, self.n)

    @property
    def hi(self) -> int:
        return min(self.lo + self.chunk, self.n)

    def own(self, x):
        """This rank's rows of replicated node rows ``x`` ``[n, ...]``."""
        return x[self.lo:self.hi]

    def gather(self, x):
        """Every rank's rows ``[n, ...]`` from this rank's ``x``."""
        return _GatherNodes.apply(x, self)

    def scatter(self, x):
        """This rank's rows of the sum over ranks of partial node sums
        ``x`` ``[n, ...]``."""
        return _ScatterNodes.apply(x, self)

    def total(self, x):
        """``x`` summed over the ranks (identity backward): a loss term
        each rank computes on its own rows."""
        return _ReduceFromEdges.apply(x, self.group)


def node_rows(plan: Optional[EdgePlan]) -> Optional[NodeRows]:
    """The rank's :class:`NodeRows` when ``plan`` is an edge shard of a
    group (rank and world are the group's); ``None`` otherwise: one shard
    holds every edge and every row."""
    if plan is None or plan.group is None:
        return None
    g = plan.group
    return NodeRows(n=plan.n, group=g, rank=torch.distributed.get_rank(g),
                    world=torch.distributed.get_world_size(g))


def _pad_rows(x, rows: int):
    if x.shape[0] == rows:
        return x.contiguous()
    return torch.cat([x, x.new_zeros((rows - x.shape[0],) + tuple(x.shape[1:]))])


def _all_gather(x, rows: NodeRows):
    out = x.new_empty((rows.world * rows.chunk,) + tuple(x.shape[1:]))
    torch.distributed.all_gather_into_tensor(out, _pad_rows(x, rows.chunk), group=rows.group)
    return out[: rows.n]


def _reduce_scatter(x, rows: NodeRows):
    out = x.new_empty((rows.chunk,) + tuple(x.shape[1:]))
    torch.distributed.reduce_scatter_tensor(out, _pad_rows(x, rows.world * rows.chunk),
                                            group=rows.group)
    return out[: rows.hi - rows.lo]


class _GatherNodes(torch.autograd.Function):
    """All-gather forward, reduce-scatter of the gradient backward."""

    @staticmethod
    def forward(ctx, x, rows):
        ctx.rows = rows
        return _all_gather(x, rows)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.rows), None


class _ScatterNodes(torch.autograd.Function):
    """Reduce-scatter forward, all-gather of the gradient backward."""

    @staticmethod
    def forward(ctx, x, rows):
        ctx.rows = rows
        return _reduce_scatter(x, rows)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.rows), None


def _own(x, rows: Optional[NodeRows]):
    return x if rows is None else rows.own(x)


def _gathered(h, rows: Optional[NodeRows]):
    # a node of the autograd graph either way: the gradients of the rows'
    # readers add up there first, in the same order with and without the
    # gather (at world 1 the node-sharded step is bitwise the one-shard one)
    return h.view_as(h) if rows is None else rows.gather(h)


def _scattered(s, rows: Optional[NodeRows]):
    return s if rows is None else rows.scatter(s)


def gather_rows(x, idx, plan: EdgePlan, by: str):
    """``x[idx]`` for node rows ``x`` ``[n, ...]`` and the edges' clamped
    sources (``by="src"``) or destinations (``by="dst"``) ``idx`` (int64)."""
    flat = _cols(x)
    out = (_GatherRows.apply(flat, idx, plan, by) if _record(flat)
           else flat.index_select(0, idx))
    return out.reshape((idx.shape[0],) + tuple(x.shape[1:]))


def source_sum(h, plan: EdgePlan):
    """``[n, C]`` node rows summed into each node over its valid incoming
    edges' sources: one K1 launch on ``by_src``."""
    return _SourceSum.apply(h, plan) if _record(h) else _sum_all(plan.by_src, h)


def scatter_sum(messages, dst, n, plan: Optional[EdgePlan] = None):
    """Per-edge ``messages`` ``[E, ...]`` summed into their destination:
    ``[n, ...]`` float32, one K1 launch (edges with ``dst >= n`` reach no
    node); on an edge shard, the shard's partial sums."""
    plan = _plan_for(plan, None, dst, n, messages.device)
    cols = _cols(messages)
    if _record(cols):
        out = _ScatterSum.apply(cols, torch.as_tensor(dst, device=cols.device), plan)
    else:
        out = _sum_all(plan.by_edge, cols)
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
    exponentials.

    The max is taken on detached scores: softmax is invariant to the shift,
    so the total gradient through it is zero (the reference differentiates
    through ``segment_max`` and gets that zero up to rounding).  An edge
    shard takes the max over every shard (``all_reduce`` MAX) and reads the
    whole denominator (its partial sums through g, then f)."""
    plan = _plan_for(plan, None, dst, n, scores.device)
    ed = torch.clamp(torch.as_tensor(dst, device=scores.device), max=n - 1).long()
    h = scores.shape[1]
    m = segment_reduce_multi(plan.by_edge, scores.detach(), (0, 0, h))
    if plan.group is not None:
        torch.distributed.all_reduce(m, op=torch.distributed.ReduceOp.MAX, group=plan.group)
    m = torch.nan_to_num(m[ed], neginf=0.0)
    e = torch.exp(scores - m)
    z = scatter_sum(e, dst, n, plan)
    if plan.group is not None:
        z = _CopyToEdges.apply(_ReduceFromEdges.apply(z, plan.group), plan.group)
    z = gather_rows(z, ed, plan, "dst")
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
    """Sym-normalized GCN.  edge_w = 1/sqrt(deg_s * deg_d) precomputed.
    On an edge shard (:func:`node_rows`) the result is the rank's rows."""
    dev = feats.device
    plan = _plan_for(plan, edge_src, edge_dst, n, dev)
    rows = node_rows(plan)
    ws = _shard_params(params["w"], plan)
    es, _ = _edges(edge_src, edge_dst, n, dev)
    w_e = torch.as_tensor(edge_w, device=dev).to(cfg.cdtype)[:, None]
    h = feats.to(cfg.cdtype)
    for i, w in enumerate(ws):
        x = h if i == 0 else _gathered(h, rows)  # the features are whole rows
        agg = _scattered(scatter_sum(gather_rows(x, es, plan, "src") * w_e, edge_dst, n, plan),
                         rows)
        h = agg @ w.to(cfg.cdtype)
        if i < len(ws) - 1:
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
    rows = node_rows(plan)
    params = _shard_params(params, plan)
    deg = _own(torch.clamp(plan.in_degree, min=1.0)[:, None], rows)
    x = feats.to(cfg.cdtype)
    h = _own(x, rows)
    for i, (ws, wn) in enumerate(zip(params["w_self"], params["w_nbr"])):
        if i:
            x = _gathered(h, rows)
        agg = _scattered(source_sum(x, plan), rows) / deg
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
    rows = node_rows(plan)
    params = _shard_params(params, plan)
    es, ed = _edges(edge_src, edge_dst, n, dev)
    h = _own(feats.to(cfg.cdtype), rows)
    nl = len(params["w"])
    heads = cfg.n_heads
    for i in range(nl):
        d_out = cfg.d_out if i == nl - 1 else cfg.d_hidden
        hw = (h @ params["w"][i].to(cfg.cdtype)).reshape(-1, heads, d_out)
        # a_l/a_r: [d_out, H] -> per-(node, head) scalars
        sl = torch.einsum("nhd,dh->nh", hw, params["a_l"][i].to(cfg.cdtype))
        sr = torch.einsum("nhd,dh->nh", hw, params["a_r"][i].to(cfg.cdtype))
        if rows is not None:  # one all-gather of the rank's rows of all three
            w = heads * d_out
            full = rows.gather(torch.cat([hw.reshape(-1, w), sl, sr], dim=1))
            hw, sl, sr = full.split([w, heads, heads], dim=1)  # one [n, .] gradient
            hw = hw.reshape(n, heads, d_out)
        scores = F.leaky_relu(gather_rows(sl, es, plan, "src")
                              + gather_rows(sr, ed, plan, "dst"), 0.2)
        alpha = edge_softmax(scores, edge_dst, n, plan)  # [E, H], its statistics whole
        agg = _scattered(scatter_sum(gather_rows(hw, es, plan, "src") * alpha[..., None],
                                     edge_dst, n, plan), rows)
        if i < nl - 1:
            h = F.elu(agg.reshape(-1, heads * d_out))
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
    rows = node_rows(plan)
    params = _shard_params(params, plan)
    es, ed = _edges(edge_src, edge_dst, n, dev)
    h = L.mlp_apply(params["node_enc"], _own(feats.to(cfg.cdtype), rows))
    e = L.mlp_apply(params["edge_enc"], edge_feats.to(cfg.cdtype))

    def run(h, e, lps):
        for lp in lps:
            x = _gathered(h, rows)
            inp = torch.cat([e, gather_rows(x, es, plan, "src"), gather_rows(x, ed, plan, "dst")],
                            dim=-1)
            e = e + L.mlp_apply(lp["edge_mlp"], inp)
            agg = _scattered(scatter_sum(e, edge_dst, n, plan), rows)
            h = h + L.mlp_apply(lp["node_mlp"], torch.cat([h, agg], dim=-1))
        return h, e

    proc = params["proc"]
    if _record(h, e, *leaves(proc)):
        # the backward keeps each chunk's input carries (h, and e: |E| x d
        # floats) and recomputes the chunk
        chunk = remat_chunk if cfg.n_layers % remat_chunk == 0 else 1
        for i in range(0, len(proc), chunk):
            h, e = checkpoint(run, h, e, proc[i:i + chunk], use_reentrant=False)
    else:
        h, e = run(h, e, proc)
    return L.mlp_apply(params["node_dec"], h)


# ---------------- paper-technique integration ------------------------- #
def khop_aggregate(plan, node_values):
    """k-hop window SUM of node features ``[n]`` or ``[n, D]`` via the
    DBIndex plan (:class:`~repro_torch.core.engine_torch.DBIndexPlan`): the
    paper's shared two-stage aggregation as a GNN feature operator, two K1
    launches whatever ``D``."""
    from repro_torch.core.engine_torch import query_dbindex

    return query_dbindex(plan, node_values, "sum")

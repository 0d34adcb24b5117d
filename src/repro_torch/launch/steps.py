"""Step builders: (config, mesh, dims) -> a step, its argument stand-ins and
their partition specs.

The reference's builders hand ``jax.jit`` a function and its shardings.
Here a :class:`BuiltStep` holds the function each rank runs on its own
pieces of the arguments (SPMD over a ``torch.distributed`` ``DeviceMesh``;
``mesh=None`` is one card), meta-device stand-ins for the arguments
(never allocated, as the reference's ``ShapeDtypeStruct``\\ s), each
argument's spec tree (:mod:`repro_torch.distributed.sharding_rules`) and
:meth:`BuiltStep.shard`, which cuts whole arguments into this rank's
pieces by those specs.

Ported so far:

* GNN train: :func:`gnn_loss` (the reference's, letter for letter) and
  :func:`build_gnn_train` (``value_and_grad`` + AdamW with the reference's
  cosine schedule), edges sharded over the whole mesh;
* paper-gwq: :func:`build_gwq_step`, the paper's two-pass data plane.

The LM and FM builders (``build_lm_train`` / ``prefill`` / ``decode``,
``build_fm_step``) come with the production mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding_rules import Spec, entry_axes
from repro_torch.launch.mesh import dp_axes_of
from repro_torch.models import gnn as G
from repro_torch.optim.optimizers import adamw
from repro_torch.optim.schedules import cosine_schedule
from repro_torch.train.trainer import value_and_grad
from repro_torch.tree import tree_map


@dataclasses.dataclass
class BuiltStep:
    """``fn(*pieces, plan=None)`` runs on each rank on its pieces of the
    arguments; ``args`` are meta-device stand-ins of the whole arguments
    and ``in_specs`` their spec trees (``out_specs`` the results').
    ``plan(*pieces)`` builds, on the host, the plan the step's kernels run
    on from this rank's pieces: ``fn`` builds it when not given one, so a
    caller that runs many steps on one graph builds it once."""

    fn: Callable
    args: Tuple[Any, ...]
    in_specs: Tuple[Any, ...]
    out_specs: Any
    plan: Callable
    mesh: Any = None
    device: torch.device = torch.device("cpu")

    def shard(self, *args) -> Tuple[Any, ...]:
        """This rank's pieces of whole arguments (trees of tensors or NumPy
        arrays) on the step's device: each dimension a spec names is cut
        into equal contiguous pieces over those mesh axes, the first axis
        major (the reference's layout)."""
        return tuple(_shard_tree(a, s, self.mesh, self.device)
                     for a, s in zip(args, self.in_specs))

    def run(self, *args, **kw):
        """``fn`` on this rank's pieces of whole arguments."""
        return self.fn(*self.shard(*args), **kw)


def _mesh_group(mesh, axes: Tuple[str, ...]):
    """(shards, this rank's shard, process group) over mesh ``axes``; the
    group is ``None`` over one shard."""
    if mesh is None or not axes:
        return 1, 0, None
    from repro_torch.distributed.window_runtime import _mesh_shard

    count, index, group = _mesh_shard(mesh, axes)
    return count, index, (group if count > 1 else None)


def _piece(x, spec: Spec, mesh, dev: torch.device) -> torch.Tensor:
    t = torch.as_tensor(x)
    for dim, entry in enumerate(spec):
        count, index, _ = _mesh_group(mesh, entry_axes(entry))
        if count == 1:
            continue
        if t.shape[dim] % count:
            raise ValueError(f"dim {dim} of size {t.shape[dim]} does not split "
                             f"{count} ways ({spec})")
        size = t.shape[dim] // count
        t = t.narrow(dim, index * size, size)
    return t.contiguous().to(dev)


def _shard_tree(tree, specs, mesh, dev):
    if isinstance(specs, Spec):
        return _piece(tree, specs, mesh, dev)
    if isinstance(tree, dict):
        return {k: _shard_tree(tree[k], specs[k], mesh, dev) for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_shard_tree(a, s, mesh, dev) for a, s in zip(tree, specs)])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_shard_tree(a, s, mesh, dev) for a, s in zip(tree, specs))
    raise TypeError(f"no spec for {type(tree)}")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _meta_tree(init: Callable):
    """Stand-ins of the tree ``init(generator)`` returns: it runs under
    ``FakeTensorMode`` (shapes only, nothing allocated) and each leaf
    becomes a meta tensor."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        fake = init(torch.Generator())
    return tree_map(lambda t: _meta(t.shape, t.dtype), fake)


# ---------------------------------------------------------------------- #
#  GNN family
# ---------------------------------------------------------------------- #
_INIT = {"gcn": G.gcn_init, "sage": G.sage_init, "gat": G.gat_init,
         "meshgraphnet": G.mgn_init}


def gnn_loss(params, batch, cfg: G.GNNConfig, n: int, node_spec=None,
             plan: Optional[G.EdgePlan] = None):
    """The reference's GNN loss: masked NLL over float32 logits (gcn, sage,
    gat; the mean over all nodes without ``label_mask``), or the MSE
    against ``targets`` (meshgraphnet).  The label's logit is picked by a
    mask and a sum, which is exact and whose backward is elementwise (the
    backward of ``gather`` adds with atomics on the card)."""
    es, ed = batch["edge_src"], batch["edge_dst"]
    feats = batch["feats"]
    if cfg.kind == "gcn":
        out = G.gcn_forward(params, feats, es, ed, batch["edge_w"], n, cfg,
                            node_spec=node_spec, plan=plan)
    elif cfg.kind == "sage":
        out = G.sage_forward(params, feats, es, ed, n, cfg, node_spec=node_spec, plan=plan)
    elif cfg.kind == "gat":
        out = G.gat_forward(params, feats, es, ed, n, cfg, node_spec=node_spec, plan=plan)
    else:
        out = G.mgn_forward(params, feats, batch["edge_feats"], es, ed, n, cfg,
                            node_spec=node_spec, plan=plan)
    if cfg.kind == "meshgraphnet":
        return torch.mean(torch.square(out - batch["targets"]))
    labels = batch["labels"]
    mask = batch.get("label_mask", None)
    logits = out.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    pick = torch.arange(logits.shape[-1], device=logits.device) == labels[:, None].long()
    ll = torch.where(pick, logits, torch.zeros((), device=logits.device)).sum(dim=-1)
    nll = lse - ll
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def gnn_optimizer():
    """The GNN step's optimizer: AdamW on ``cosine_schedule(1e-3, 100,
    10_000)``, as the reference's (``init`` gives the step's first state)."""
    return adamw(cosine_schedule(1e-3, 100, 10_000))


def gnn_value_and_grad(params, batch, cfg: G.GNNConfig, n: int,
                       plan: Optional[G.EdgePlan] = None):
    """(loss, grads) of :func:`gnn_loss` with respect to every param."""
    return value_and_grad(lambda p, b: gnn_loss(p, b, cfg, n, plan=plan), params, batch)


def gnn_edge_plan(batch, n: int, group=None, torch_device="cuda") -> G.EdgePlan:
    """The :class:`~repro_torch.models.gnn.EdgePlan` of a rank's edge shard
    (``batch["edge_src"]``, ``batch["edge_dst"]``): over a ``group`` its
    ``in_degree`` is summed across the shards, the whole graph's."""
    plan = G.edge_plan(batch["edge_src"], batch["edge_dst"], n, torch_device=torch_device)
    if group is None:
        return plan
    deg = plan.in_degree.clone()
    dist.all_reduce(deg, group=group)
    return dataclasses.replace(plan, in_degree=deg, group=group)


def build_gnn_train(cfg: G.GNNConfig, mesh, dims: Dict[str, int],
                    torch_device="cuda") -> BuiltStep:
    """The reference's GNN train step: ``value_and_grad(gnn_loss)``, then
    AdamW on ``cosine_schedule(1e-3, 100, 10_000)``; returns ``(params,
    opt_state, {"loss", "gnorm"})``.

    Edges shard over the whole mesh (every axis, as ``gnn_specs`` puts the
    dp axes and the reference adds ``"model"``): each rank runs K1 on its
    own edge shard.  Node states and params are replicated on every rank,
    where the reference shards node states over the mesh (``node_spec``):
    replicated rows enter a shard through an identity whose backward is an
    ``all_reduce``, and a shard's partial node sums leave it through an
    ``all_reduce`` whose backward is the identity (``models/gnn.py``), so
    every rank ends a step with the same loss, gradients and params.  Over
    one shard (``mesh=None`` or a mesh of one device) there is no
    collective: the step is bitwise the one-card step."""
    dev = resolve_device(torch_device)
    axes = (tuple(dp_axes_of(mesh)) + ("model",)) if mesh is not None else ()
    ndev, _, group = _mesh_group(mesh, axes)
    opt = gnn_optimizer()
    params_s = _meta_tree(lambda g: _INIT[cfg.kind](g, cfg))
    opt_s = opt.init(params_s)

    n = dims.get("sub_n", dims["n"] * dims.get("batch", 1))
    e = dims.get("sub_e", dims["e"] * dims.get("batch", 1))
    e_pad = -(-e // (128 * ndev)) * (128 * ndev)  # a lane multiple over the mesh
    d = Spec(axes) if axes else Spec(None)
    batch = {"feats": _meta((n, dims["d_feat"]), torch.float32),
             "edge_src": _meta((e_pad,), torch.int32),
             "edge_dst": _meta((e_pad,), torch.int32)}
    bspec = {"feats": Spec(), "edge_src": d, "edge_dst": d}
    if cfg.kind == "gcn":
        batch["edge_w"] = _meta((e_pad,), torch.float32)
        bspec["edge_w"] = d
    if cfg.kind == "meshgraphnet":
        batch["edge_feats"] = _meta((e_pad, 3), torch.float32)
        batch["targets"] = _meta((n, cfg.d_out), torch.float32)
        bspec["edge_feats"] = Spec(*d, None)
        bspec["targets"] = Spec()
    else:
        batch["labels"] = _meta((n,), torch.int32)
        batch["label_mask"] = _meta((n,), torch.float32)
        bspec["labels"] = Spec()
        bspec["label_mask"] = Spec()

    def make_plan(params, opt_state, batch):
        return gnn_edge_plan(batch, n, group, torch_device=dev)

    def train_step(params, opt_state, batch, plan=None):
        if plan is None:
            plan = make_plan(params, opt_state, batch)
        loss, grads = gnn_value_and_grad(params, batch, cfg, n, plan)
        params, opt_state, gnorm = opt.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss, "gnorm": gnorm}

    from repro_torch.distributed.sharding_rules import opt_state_specs

    pspec = tree_map(lambda _: Spec(), params_s)
    ospec = opt_state_specs(pspec, opt_s)
    return BuiltStep(fn=train_step, args=(params_s, opt_s, batch),
                     in_specs=(pspec, ospec, bspec),
                     out_specs=(pspec, ospec, {"loss": Spec(), "gnorm": Spec()}),
                     plan=make_plan, mesh=mesh, device=dev)


# ---------------------------------------------------------------------- #
#  paper-gwq: the sharded window-query data plane
# ---------------------------------------------------------------------- #
def _rows_plan(gather, seg, num_segments: int, num_rows: int, dev):
    """K1's tile plan of one pass from a rank's rows (``seg < 0``: a pad
    row), sorted by segment on the host (stable)."""
    from repro_torch.kernels.segment_reduce.ops import build_tile_plan

    gather, seg = np.asarray(_host(gather)), np.asarray(_host(seg))
    ok = seg >= 0
    g, s = gather[ok], seg[ok].astype(np.int64)
    if s.size and (s.max() >= num_segments or g.min() < 0 or g.max() >= num_rows):
        raise ValueError("a row's segment or gather index is out of range")
    order = np.argsort(s, kind="stable")
    return build_tile_plan(g[order], s[order], num_segments, torch_device=dev)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def build_gwq_step(plan_dims: Dict[str, int], mesh, torch_device="cuda") -> BuiltStep:
    """The paper's two-stage DBIndex query over a mesh: pass 1 sums member
    rows ``vals[p1g]`` into blocks ``p1s``, pass 2 sums block rows
    ``t[p2g]`` into owners ``p2s`` (``seg < 0``: a pad row).  Rows shard
    over the dp axes, ``vals`` is replicated; each pass is one K1 launch on
    this rank's rows, then an ``all_reduce`` over the dp axes, so the
    result is the whole plan's on every rank.

    ``boundary_frac`` (the reference's locality-partitioned variant) keeps
    the first ``nb - nb // bf`` blocks and ``n - n // bf`` owners local and
    all-reduces only the boundary slices, with the reference's arithmetic
    as it is: where a shard's rows are not co-located with their blocks,
    each rank returns its own partial interior, as the reference's
    ``shard_map`` does."""
    dev = resolve_device(torch_device)
    dp = tuple(dp_axes_of(mesh)) if mesh is not None else ()
    ndev, _, group = _mesh_group(mesh, dp)
    n, nb = plan_dims["n"], plan_dims["nb"]
    m, l = plan_dims["m"], plan_dims["l"]
    m_pad = -(-m // (128 * ndev)) * (128 * ndev)
    l_pad = -(-l // (128 * ndev)) * (128 * ndev)
    args = (_meta((m_pad,), torch.int32), _meta((m_pad,), torch.int32),
            _meta((l_pad,), torch.int32), _meta((l_pad,), torch.int32),
            _meta((n,), torch.float32))
    bf = plan_dims.get("boundary_frac")

    def make_plan(p1g, p1s, p2g, p2s, vals=None):
        return (_rows_plan(p1g, p1s, nb, n, dev), _rows_plan(p2g, p2s, n, nb, dev))

    def combine(x, lo: int):
        if group is not None:
            dist.all_reduce(x[lo:], group=group)
        return x

    def gwq_query(p1g, p1s, p2g, p2s, vals, plan=None):
        from repro_torch.kernels.segment_reduce.ops import segment_sum

        p1, p2 = plan if plan is not None else make_plan(p1g, p1s, p2g, p2s)
        vals = torch.as_tensor(vals, device=dev)
        t = combine(segment_sum(p1, vals), nb - nb // bf if bf else 0)
        return combine(segment_sum(p2, t), n - n // bf if bf else 0)

    d = Spec(dp if len(dp) > 1 else dp[0]) if dp else Spec(None)
    return BuiltStep(fn=gwq_query, args=args, in_specs=(d, d, d, d, Spec()),
                     out_specs=Spec(), plan=make_plan, mesh=mesh, device=dev)

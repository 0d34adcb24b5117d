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

One builder per family, as in the reference:

* LM train / prefill / decode (:func:`build_lm_train`,
  :func:`build_lm_prefill`, :func:`build_lm_decode`): FSDP x TP over
  DTensors.  Each rank's pieces become DTensors at their specs'
  placements; right before a layer uses a weight it is redistributed with
  the dp axes dropped (the FSDP all-gather, whose backward is a
  reduce-scatter), the ``"model"`` axis stays split (TP), the activations
  are anchored by :mod:`repro_torch.distributed.actshard`, and K3 runs on
  each rank's local shards.  The LM params are the reference's tree, the
  layers stacked ``[L, ...]``; the step unbinds them for the model;
* GNN train: :func:`gnn_loss` (the reference's, letter for letter) and
  :func:`build_gnn_train` (``value_and_grad`` + AdamW with the reference's
  cosine schedule), edges sharded over the whole mesh;
* recsys (:func:`build_fm_step`): train, serve and retrieval, the table
  row-split over ``"model"``, K4 on each rank's batch rows;
* paper-gwq: :func:`build_gwq_step`, the paper's two-pass data plane.

Over ``mesh=None`` or a mesh of one device a step runs plain tensors on
one device, bitwise the step with no mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.distributed import sharding_rules as SR
from repro_torch.distributed.sharding_rules import Spec, entry_axes
from repro_torch.launch.mesh import dp_axes_of
from repro_torch.models import gnn as G
from repro_torch.models import moe as MoE
from repro_torch.models import recsys as R
from repro_torch.models import transformer as T
from repro_torch.optim.optimizers import adafactor, adamw
from repro_torch.optim.schedules import cosine_schedule
from repro_torch.train.trainer import value_and_grad
from repro_torch.tree import tree_map


def _no_plan(*pieces):
    return None


@dataclasses.dataclass
class BuiltStep:
    """``fn(*pieces)`` runs on each rank on its pieces of the arguments;
    ``args`` are meta-device stand-ins of the whole arguments and
    ``in_specs`` their spec trees (``out_specs`` the results', each rank
    returning its pieces).  The GNN and gwq steps also take ``plan=``:
    ``plan(*pieces)`` builds, on the host, the plan their kernels run on
    from this rank's pieces, and ``fn`` builds it when not given one, so a
    caller that runs many steps on one graph builds it once.
    ``donate_argnums`` are the arguments the step replaces, as the
    reference donates them (params and optimizer state; a decode step's
    cache, which it updates in place on one device)."""

    fn: Callable
    args: Tuple[Any, ...]
    in_specs: Tuple[Any, ...]
    out_specs: Any
    plan: Callable = _no_plan
    mesh: Any = None
    device: torch.device = torch.device("cpu")
    donate_argnums: Tuple[int, ...] = ()

    def shard(self, *args) -> Tuple[Any, ...]:
        """This rank's pieces of whole arguments (trees of tensors or NumPy
        arrays) on the step's device: each dimension a spec names is cut
        into equal contiguous pieces over those mesh axes, the first axis
        major (the reference's layout)."""
        return tuple(_map_specs2(lambda t, sp: _piece(t, sp, self.mesh, self.device), a, s)
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


def _map_specs2(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree of dicts, lists and named tuples and
    its spec tree."""
    if isinstance(specs, Spec):
        return fn(tree, specs)
    if isinstance(tree, dict):
        return {k: _map_specs2(fn, tree[k], specs[k]) for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_map_specs2(fn, a, sp) for a, sp in zip(tree, specs)])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_specs2(fn, a, sp) for a, sp in zip(tree, specs))
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
#  pieces <-> DTensors
# ---------------------------------------------------------------------- #
def _sharded(mesh) -> bool:
    """A step over ``mesh`` runs DTensors: a mesh of more than one device."""
    return mesh is not None and mesh.size() > 1


def _dp_spec(dp_axes):
    """The spec entry of the dp axes: one name, or their tuple."""
    return SR._fsdp(tuple(dp_axes))


def _dp_axes(mesh) -> Tuple[str, ...]:
    """The mesh's dp axes (``("data",)`` with no mesh: the specs a step
    without a mesh records, which cut nothing)."""
    return tuple(dp_axes_of(mesh)) if mesh is not None else ("data",)


def _wrap(tree, specs, mesh):
    """Each rank's pieces as DTensors at their specs' placements."""
    from torch.distributed.tensor import DTensor

    return _map_specs2(lambda t, sp: DTensor.from_local(t, mesh, SR.placements(sp, mesh),
                                                        run_check=False), tree, specs)


def _unwrap(tree, specs, mesh):
    """DTensors back to this rank's contiguous pieces at their specs'
    placements (``Spec()``: the whole value)."""
    return _map_specs2(lambda t, sp: t.redistribute(mesh, SR.placements(sp, mesh))
                       .to_local().contiguous(), tree, specs)


def _replicated(x):
    """A DTensor scalar (a loss, a partial sum over ranks) made whole on
    every rank; its backward keeps the gradient replicated, so every rank's
    contribution reaches the params (``to_local`` alone would drop the
    reduction); a plain tensor as it is."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def _laid_out_as(grads, params):
    """Each gradient redistributed to its param's placements.  A param
    replicated over an axis gets a partial sum there from each rank's
    backward; the optimizer's casts and roots need it whole (an all-reduce
    here), else each rank would round its own partial."""
    from torch.distributed.tensor import DTensor

    def one(g, p):
        if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
            return g.redistribute(p.device_mesh, p.placements)
        return g

    return tree_map(one, grads, params)


class _Gathered(dict):
    """A param dict whose DTensor leaves come out with the dp axes dropped
    from their placements: the FSDP all-gather, right where a layer reads a
    weight (its backward reduce-scatters the gradient).  A layer run under
    ``torch.utils.checkpoint`` gathers again in its recomputation, so no
    gathered weight outlives its layer."""

    def __init__(self, tree, dp_dims: Tuple[int, ...]):
        super().__init__(tree)
        self._dp = dp_dims

    def __getitem__(self, key):
        v = super().__getitem__(key)
        if isinstance(v, list):
            return [_Gathered(lp, self._dp) for lp in v]
        from torch.distributed.tensor import Replicate

        pl = [Replicate() if i in self._dp else p for i, p in enumerate(v.placements)]
        return v.redistribute(v.device_mesh, pl)

    def get(self, key, default=None):
        return self[key] if key in self else default


def _layer_list(params):
    """The reference's stacked tree -> the port's model tree: ``layers``
    unbound into one dict a layer (views; the backward stacks the
    gradients)."""
    stacked = params["layers"]
    keys = list(stacked)
    layers = [dict(zip(keys, vals)) for vals in zip(*(torch.unbind(stacked[k]) for k in keys))]
    return {**params, "layers": layers}


def _stacked(params):
    """The port's model tree -> the reference's, the layers stacked."""
    layers = params["layers"]
    return {**params, "layers": {k: torch.stack([lp[k] for lp in layers]) for k in layers[0]}}


def _model_params(params, mesh):
    """The stacked params as the model reads them: one dict a layer, and
    over a mesh each DTensor gathered over the dp axes where it is read."""
    tree = _layer_list(params)
    if not _sharded(mesh):
        return tree
    names = tuple(mesh.mesh_dim_names)
    return _Gathered(tree, tuple(i for i, n in enumerate(names) if n in ("pod", "data")))


def _run(mesh, fn, *args):
    """``fn`` under DTensor's implicit replication of plain tensors (RoPE
    tables, masks, scalars) over a mesh; as it is on one device."""
    if not _sharded(mesh):
        return fn(*args)
    from torch.distributed.tensor.experimental import implicit_replication

    with implicit_replication():
        return fn(*args)


# ---------------------------------------------------------------------- #
#  LM family
# ---------------------------------------------------------------------- #
def _lm_module(cfg):
    return MoE if isinstance(cfg, MoE.MoEConfig) else T


def _lm_optimizer(cfg):
    """Adafactor on ``cosine_schedule(1e-4, 200, 10_000)`` above 20 B params
    (grok-1: its factored state is the memory floor), else AdamW with bf16
    moments on ``cosine_schedule(3e-4, 200, 10_000)``: the reference's."""
    if cfg.n_params() > 20e9:
        return adafactor(cosine_schedule(1e-4, 200, 10_000))
    return adamw(cosine_schedule(3e-4, 200, 10_000))


def _lm_param_specs(cfg, dp_axes):
    if isinstance(cfg, MoE.MoEConfig):
        ep = cfg.pad_experts_to is not None
        return SR.moe_param_specs(cfg, dp_axes, expert_parallel=ep)
    return SR.lm_param_specs(cfg, dp_axes)


def lm_params_meta(cfg):
    """Meta stand-ins of an LM's float32 master params in the reference's
    tree (layers stacked)."""
    mod = _lm_module(cfg)
    return _meta_tree(lambda g: _stacked(mod.init_master(g, cfg)))


def stack_layers(params):
    """An LM's params as the port's model holds them (one dict a layer)
    -> the tree the LM step builders take (the layers stacked, as the
    reference's)."""
    return _stacked(params)


def build_lm_train(cfg, mesh, shape_dims, torch_device="cuda") -> BuiltStep:
    """The reference's LM train step: ``value_and_grad`` of the model's
    ``loss_fn`` under :func:`~repro_torch.distributed.actshard.lm_train_acts`,
    then :func:`_lm_optimizer`'s update; returns ``(params, opt_state,
    {"loss", "gnorm"})``, params and optimizer state donated.  Over a mesh
    the loss is made whole (an all-reduce over the dp axes) before the
    gradient, so each rank's share of it reaches every gradient."""
    dev = resolve_device(torch_device)
    dp_axes = _dp_axes(mesh)
    mod = _lm_module(cfg)
    opt = _lm_optimizer(cfg)
    params_s = lm_params_meta(cfg)
    opt_s = opt.init(params_s)
    b, s = shape_dims["batch"], shape_dims["seq"]
    batch = {"tokens": _meta((b, s), torch.int32), "labels": _meta((b, s), torch.int32)}
    from repro_torch.distributed.actshard import lm_train_acts

    acts = lm_train_acts(dp_axes, mesh)
    pspec = _lm_param_specs(cfg, dp_axes)
    ospec = SR.opt_state_specs(pspec, opt_s)
    bspec = SR.lm_batch_specs(dp_axes)

    def loss_of(p, bt):
        return _replicated(mod.loss_fn(_model_params(p, mesh), bt, cfg, acts=acts))

    def step(params, opt_state, batch):
        loss, grads = value_and_grad(loss_of, params, batch)
        params, opt_state, gnorm = opt.update(_laid_out_as(grads, params), opt_state, params)
        return params, opt_state, loss, gnorm

    def train_step(params, opt_state, batch):
        if _sharded(mesh):
            params, opt_state, batch = (_wrap(params, pspec, mesh),
                                        _wrap(opt_state, ospec, mesh),
                                        _wrap(batch, bspec, mesh))
        params, opt_state, loss, gnorm = _run(mesh, step, params, opt_state, batch)
        if _sharded(mesh):
            params, opt_state = _unwrap(params, pspec, mesh), _unwrap(opt_state, ospec, mesh)
            loss, gnorm = _unwrap(_replicated(loss), Spec(), mesh), _unwrap(
                _replicated(gnorm), Spec(), mesh)
        return params, opt_state, {"loss": loss, "gnorm": gnorm}

    return BuiltStep(fn=train_step, args=(params_s, opt_s, batch),
                     in_specs=(pspec, ospec, bspec),
                     out_specs=(pspec, ospec, {"loss": Spec(), "gnorm": Spec()}),
                     mesh=mesh, device=dev, donate_argnums=(0, 1))


def build_lm_prefill(cfg, mesh, shape_dims, torch_device="cuda") -> BuiltStep:
    """The reference's prompt pass: ``(kv cache, last-token logits)``, the
    cache ``[L, B, Hkv, S, D]`` at ``Spec(None, dp, None, "model", None)``
    (the sequence over ``"model"``) and the logits at ``Spec(dp,
    "model")``."""
    dev = resolve_device(torch_device)
    dp_axes = _dp_axes(mesh)
    mod = _lm_module(cfg)
    params_s = lm_params_meta(cfg)
    b, s = shape_dims["batch"], shape_dims["seq"]
    tokens = _meta((b, s), torch.int32)
    from repro_torch.distributed.actshard import lm_prefill_acts

    acts = lm_prefill_acts(dp_axes, mesh)
    pspec = _lm_param_specs(cfg, dp_axes)
    d = _dp_spec(dp_axes)
    kv_spec = {"k": Spec(None, d, None, "model", None), "v": Spec(None, d, None, "model", None)}
    tspec, lspec = Spec(d, None), Spec(d, "model")

    @torch.no_grad()
    def prefill_step(params, tokens):
        if _sharded(mesh):
            params, tokens = _wrap(params, pspec, mesh), _wrap(tokens, tspec, mesh)
        kv, logits = _run(mesh, mod.prefill, _model_params(params, mesh), tokens, cfg,
                          None, acts)
        if _sharded(mesh):
            kv, logits = _unwrap(kv, kv_spec, mesh), _unwrap(logits, lspec, mesh)
        return kv, logits

    return BuiltStep(fn=prefill_step, args=(params_s, tokens), in_specs=(pspec, tspec),
                     out_specs=(kv_spec, lspec), mesh=mesh, device=dev)


def build_lm_decode(cfg, mesh, shape_dims, torch_device="cuda") -> BuiltStep:
    """The reference's decode step: one token a row against a full cache at
    position ``seq - 1``; returns ``(logits, kv)``, the cache donated.  With
    a batch of at least the dp shards the batch splits over the dp axes and
    the cache's sequence over ``"model"``; below that (one long sequence)
    the tokens replicate and the cache's sequence splits over the whole
    mesh.  The decode attention reads the sequence whole: each layer
    gathers its cache's sequence first (a flash-decoding combine over the
    shards is later work)."""
    dev = resolve_device(torch_device)
    dp_axes = _dp_axes(mesh)
    mod = _lm_module(cfg)
    params_s = lm_params_meta(cfg)
    b, s = shape_dims["batch"], shape_dims["seq"]
    hd = cfg.head_dim
    kv = {k: _meta((cfg.n_layers, b, cfg.n_kv_heads, s, hd), cfg.cdtype) for k in ("k", "v")}
    token = _meta((b,), torch.int32)
    from repro_torch.distributed.actshard import lm_decode_acts

    acts = lm_decode_acts(dp_axes, mesh)
    pspec = _lm_param_specs(cfg, dp_axes)
    d = _dp_spec(dp_axes)
    ndp = 1
    if mesh is not None:
        names = tuple(mesh.mesh_dim_names)
        for a in dp_axes:
            ndp *= mesh.size(names.index(a))
    if b >= ndp:
        tok_spec = Spec(d)
        kv_spec = {"k": Spec(None, d, None, "model", None),
                   "v": Spec(None, d, None, "model", None)}
        logit_spec = Spec(d, "model")
    else:
        flat = tuple(dp_axes) + ("model",)
        tok_spec = Spec()
        kv_spec = {"k": Spec(None, None, None, flat, None),
                   "v": Spec(None, None, None, flat, None)}
        logit_spec = Spec(None, "model")

    @torch.no_grad()
    def decode(params, token, kv):
        if _sharded(mesh):
            params, token, kv = (_wrap(params, pspec, mesh), _wrap(token, tok_spec, mesh),
                                 _wrap(kv, kv_spec, mesh))
        logits, kv = _run(mesh, mod.decode_step, _model_params(params, mesh), token, kv,
                          s - 1, cfg, acts)
        if _sharded(mesh):
            logits, kv = _unwrap(logits, logit_spec, mesh), _unwrap(kv, kv_spec, mesh)
        return logits, kv

    return BuiltStep(fn=decode, args=(params_s, token, kv),
                     in_specs=(pspec, tok_spec, kv_spec), out_specs=(logit_spec, kv_spec),
                     mesh=mesh, device=dev, donate_argnums=(2,))


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
    backward of ``gather`` adds with atomics on the card).

    On an edge shard (a ``plan`` with a group, over which node rows shard
    too: the forward returns the rank's rows, :func:`~repro_torch.models.
    gnn.node_rows`) each rank reads its rows of ``labels``, ``label_mask``
    and ``targets``, and its sums are added over the ranks (the backward of
    that sum is the identity), so every rank holds the whole graph's loss.
    ``node_spec`` is the reference's parameter, accepted and not read."""
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
    rows = G.node_rows(plan)
    own = (lambda x: x) if rows is None else rows.own
    total = (lambda x: x) if rows is None else rows.total
    if cfg.kind == "meshgraphnet":
        sq = torch.sum(torch.square(out - own(batch["targets"])))
        return total(sq) / (n * cfg.d_out)
    labels = own(batch["labels"])
    mask = batch.get("label_mask", None)
    logits = out.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    pick = torch.arange(logits.shape[-1], device=logits.device) == labels[:, None].long()
    ll = torch.where(pick, logits, torch.zeros((), device=logits.device)).sum(dim=-1)
    nll = lse - ll
    if mask is None:
        return total(torch.sum(nll)) / n
    sums = total(torch.stack([torch.sum(nll * own(mask)), torch.sum(own(mask))]))
    return sums[0] / torch.clamp(sums[1], min=1.0)


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
    own edge shard.  Node states shard over the same axes, as the
    reference's ``node_spec`` ``P(d, None)``: each rank holds
    ``ceil(n / W)`` node rows, all-gathers them where its edges read them
    and reduce-scatters its partial node sums back into them
    (``models/gnn.py``), and the loss adds the ranks' sums.  The batch
    (features, labels, targets) stays replicated, as the reference's, and
    so do the params: each gradient, a partial sum on each rank, is
    all-reduced, so every rank ends a step with the same loss, gradients
    and params.  Over one shard (``mesh=None`` or a mesh of one device)
    there is no collective: the step is bitwise the one-card step."""
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
#  recsys family
# ---------------------------------------------------------------------- #
def fm_optimizer():
    """The FM train step's optimizer: AdamW on ``cosine_schedule(1e-3,
    100, 10_000)``, as the reference's."""
    return adamw(cosine_schedule(1e-3, 100, 10_000))


def build_fm_step(cfg: R.FMConfig, mesh, case_kind: str, dims,
                  torch_device="cuda") -> BuiltStep:
    """The reference's FM steps: ``train`` (``value_and_grad`` of
    ``loss_fn`` + AdamW; returns ``(params, opt_state, {"loss", "gnorm"})``),
    ``serve`` (the logits of a batch) and ``retrieval`` (one query's scores
    over candidate rows).  The table and its linear weights are row-split
    over ``"model"`` (a lookup sums over the row shards), the batch over the
    dp axes; K4 runs on each rank's batch rows."""
    dev = resolve_device(torch_device)
    dp_axes = _dp_axes(mesh)
    d = _dp_spec(dp_axes)
    params_s = _meta_tree(lambda g: R.init(g, cfg))
    pspec = {"emb": Spec("model", None), "w1": Spec("model"), "bias": Spec()}

    def wrap(tree, specs):
        return _wrap(tree, specs, mesh) if _sharded(mesh) else tree

    def unwrap(tree, specs):
        return _unwrap(tree, specs, mesh) if _sharded(mesh) else tree

    if case_kind == "train":
        opt = fm_optimizer()
        opt_s = opt.init(params_s)
        batch = {"x": _meta((dims["batch"], cfg.n_fields), torch.int32),
                 "y": _meta((dims["batch"],), torch.float32)}
        bspec = {"x": Spec(d, None), "y": Spec(d)}
        ospec = SR.opt_state_specs(pspec, opt_s)

        def step(params, opt_state, batch):
            loss, grads = value_and_grad(
                lambda p, b: _replicated(R.loss_fn(p, b, cfg)), params, batch)
            params, opt_state, gnorm = opt.update(_laid_out_as(grads, params), opt_state,
                                                  params)
            return params, opt_state, loss, gnorm

        def train_step(params, opt_state, batch):
            params, opt_state, loss, gnorm = _run(
                mesh, step, wrap(params, pspec), wrap(opt_state, ospec), wrap(batch, bspec))
            return (unwrap(params, pspec), unwrap(opt_state, ospec),
                    {"loss": unwrap(_replicated(loss), Spec()),
                     "gnorm": unwrap(_replicated(gnorm), Spec())})

        return BuiltStep(fn=train_step, args=(params_s, opt_s, batch),
                         in_specs=(pspec, ospec, bspec),
                         out_specs=(pspec, ospec, {"loss": Spec(), "gnorm": Spec()}),
                         mesh=mesh, device=dev, donate_argnums=(0, 1))
    if case_kind == "serve":
        x = _meta((dims["batch"], cfg.n_fields), torch.int32)

        @torch.no_grad()
        def serve_step(params, x):
            out = _run(mesh, R.forward, wrap(params, pspec), wrap(x, Spec(d, None)), cfg)
            return unwrap(out, Spec(d))

        return BuiltStep(fn=serve_step, args=(params_s, x), in_specs=(pspec, Spec(d, None)),
                         out_specs=Spec(d), mesh=mesh, device=dev)
    if case_kind == "retrieval":
        x = _meta((1, cfg.n_fields), torch.int32)
        cand = _meta((dims["n_candidates"],), torch.int32)

        @torch.no_grad()
        def retrieve(params, x, cand_rows):
            out = _run(mesh, R.retrieval_scores, wrap(params, pspec),
                       wrap(x, Spec(None, None)), wrap(cand_rows, Spec(d)), cfg)
            return unwrap(out, Spec(d))

        return BuiltStep(fn=retrieve, args=(params_s, x, cand),
                         in_specs=(pspec, Spec(None, None), Spec(d)), out_specs=Spec(d),
                         mesh=mesh, device=dev)
    raise ValueError(case_kind)


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
        vals = vals if isinstance(vals, torch.Tensor) else torch.as_tensor(vals, device=dev)
        t = combine(segment_sum(p1, vals), nb - nb // bf if bf else 0)
        return combine(segment_sum(p2, t), n - n // bf if bf else 0)

    d = Spec(dp if len(dp) > 1 else dp[0]) if dp else Spec(None)
    return BuiltStep(fn=gwq_query, args=args, in_specs=(d, d, d, d, Spec()),
                     out_specs=Spec(), plan=make_plan, mesh=mesh, device=dev)

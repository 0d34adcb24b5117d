"""Carry index, plan, model and training state across from the reference, as numpy arrays.

The reference package's ``DBIndex`` and ``IIndex`` and their device plans
(``DBIndexPlan``, ``IIndexPlan``) flatten to plain arrays (``np.asarray``
of each field); these functions rebuild the port's objects from them, so
the two packages can be fed the *same* index and plan and their query
paths compared in isolation from the host builders.

Training state goes both ways: the reference's stacked ``[L, ...]`` float32
params become the port's per-layer float32 masters
(:func:`lm_train_params_from_arrays`, no serving cast), port params,
gradients and moments go back to the stacked layout
(:func:`lm_tree_to_arrays`), and ``AdamWState`` and the data cursors cross
in both directions.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.dbindex import DBIndex
from repro_torch.core.engine_torch import DBIndexPlan, IIndexPlan, iindex_plan
from repro_torch.core.iindex import IIndex
from repro_torch.device import resolve_device, upload
from repro_torch.kernels.segment_reduce.ops import TilePlan

DBINDEX_FIELDS = ("block_members", "block_offsets", "link_block",
                  "link_owner_offsets")
TILE_PLAN_ARRAYS = ("gather_padded", "seg_tiles", "m2out", "first_visit")
TILE_PLAN_INTS = ("num_segments", "num_out_tiles", "tm", "ts")
IINDEX_FIELDS = ("pid", "wd_members", "wd_offsets", "level", "topo_order")


def dbindex_from_arrays(arrays: Mapping) -> DBIndex:
    """A port :class:`DBIndex` from the reference's fields: the four arrays
    of :data:`DBINDEX_FIELDS`, ``n``, ``num_blocks`` and (optionally)
    ``stats``."""
    return DBIndex(
        n=int(arrays["n"]),
        num_blocks=int(arrays["num_blocks"]),
        block_members=np.array(arrays["block_members"], np.int32),
        block_offsets=np.array(arrays["block_offsets"], np.int64),
        link_block=np.array(arrays["link_block"], np.int32),
        link_owner_offsets=np.array(arrays["link_owner_offsets"], np.int64),
        stats=dict(arrays.get("stats", {})),
    )


def _tile_plan(arrays: Mapping, prefix: str, dev: torch.device) -> TilePlan:
    return TilePlan(
        **{k: upload(arrays[f"{prefix}.{k}"], dev)
           for k in TILE_PLAN_ARRAYS},
        **{k: int(arrays[f"{prefix}.{k}"]) for k in TILE_PLAN_INTS},
        device=dev,
    )


def dbindex_plan_from_arrays(arrays: Mapping, torch_device="cuda") -> DBIndexPlan:
    """A port :class:`DBIndexPlan` on ``torch_device`` from the reference
    plan's fields: ``pass1.<f>`` / ``pass2.<f>`` for every ``TilePlan``
    field (:data:`TILE_PLAN_ARRAYS` + :data:`TILE_PLAN_INTS`),
    ``block_sizes``, ``link_counts``, ``p1_ell`` / ``p2_ell`` (``None``
    when the reference plan has none), ``n``, ``num_blocks`` and
    ``block_capacity``."""
    dev = resolve_device(torch_device)
    ell = {k: None if arrays.get(k) is None else upload(arrays[k], dev)
           for k in ("p1_ell", "p2_ell")}
    return DBIndexPlan(
        n=int(arrays["n"]),
        num_blocks=int(arrays["num_blocks"]),
        block_capacity=int(arrays["block_capacity"]),
        pass1=_tile_plan(arrays, "pass1", dev),
        pass2=_tile_plan(arrays, "pass2", dev),
        block_sizes=upload(arrays["block_sizes"], dev, np.float32),
        link_counts=upload(arrays["link_counts"], dev, np.float32),
        device=dev,
        **ell,
    )


def iindex_from_arrays(arrays: Mapping) -> IIndex:
    """A port :class:`IIndex` from the reference's fields: the arrays of
    :data:`IINDEX_FIELDS`, ``n`` and (optionally) ``stats``."""
    return IIndex(
        n=int(arrays["n"]),
        pid=np.array(arrays["pid"], np.int32),
        wd_members=np.array(arrays["wd_members"], np.int32),
        wd_offsets=np.array(arrays["wd_offsets"], np.int64),
        level=np.array(arrays["level"], np.int32),
        topo_order=np.array(arrays["topo_order"], np.int32),
        stats=dict(arrays.get("stats", {})),
    )


def iindex_plan_from_arrays(arrays: Mapping, torch_device="cuda") -> IIndexPlan:
    """A port :class:`IIndexPlan` on ``torch_device`` from the reference
    plan's fields: ``wd_plan.<f>`` for every ``TilePlan`` field,
    ``pid``, ``level`` and ``n`` (``max_level`` is ``level``'s largest).
    The port's own arrays follow from them: the level and chain layouts
    from ``pid`` and ``level``, the window-difference sizes from the tile
    plan's valid rows."""
    dev = resolve_device(torch_device)
    n = int(arrays["n"])
    seg = np.asarray(arrays["wd_plan.seg_tiles"]).reshape(-1)
    sizes = np.bincount(seg[seg >= 0], minlength=n)
    return iindex_plan(n, _tile_plan(arrays, "wd_plan", dev), arrays["pid"],
                       arrays["level"], sizes, dev)


def transformer_params_from_arrays(tree: Mapping, cfg, torch_device="cuda"):
    """The port's transformer params on ``torch_device`` from the
    reference's ``init`` tree as numpy arrays (layers stacked ``[L, ...]``),
    each cast to the dtype the port holds it in
    (:func:`~repro_torch.models.transformer.port_dtype`)."""
    from repro_torch.models.transformer import port_dtype

    return _lm_params(tree, cfg, resolve_device(torch_device), port_dtype)


def moe_params_from_arrays(tree: Mapping, cfg, torch_device="cuda"):
    """The port's MoE params on ``torch_device`` from the reference's
    ``moe.init`` tree as numpy arrays (layers stacked ``[L, ...]``, experts
    ``[L, E, d, f]``), each cast to the dtype the port holds it in
    (:func:`~repro_torch.models.moe.port_dtype`)."""
    from repro_torch.models.moe import port_dtype

    return _lm_params(tree, cfg, resolve_device(torch_device), port_dtype)


def _lm_params(tree: Mapping, cfg, dev: torch.device, port_dtype):
    def t(name, a):
        return torch.from_numpy(np.array(a, np.float32)).to(dev, port_dtype(name, cfg))

    stacked = tree["layers"]
    out = {
        "embed": t("embed", tree["embed"]),
        "layers": [{k: t(k, a[i]) for k, a in stacked.items()}
                   for i in range(cfg.n_layers)],
        "ln_f": t("ln_f", tree["ln_f"]),
    }
    if "unembed" in tree:
        out["unembed"] = t("unembed", tree["unembed"])
    return out


def fm_params_from_arrays(tree: Mapping, cfg, torch_device="cuda"):
    """The port's FM params on ``torch_device`` from the reference's
    ``init`` tree as numpy arrays."""
    dev = resolve_device(torch_device)
    return {k: torch.from_numpy(np.array(tree[k], np.float32)).to(dev, cfg.pdtype)
            for k in ("emb", "w1", "bias")}


def gnn_params_from_arrays(tree: Mapping, cfg, torch_device="cuda"):
    """The port's GNN params on ``torch_device`` from the reference's
    ``gcn_init`` / ``sage_init`` / ``gat_init`` / ``mgn_init`` tree as numpy
    arrays, each in ``cfg``'s param dtype.  MeshGraphNet's ``proc`` arrives
    stacked ``[L, ...]`` for ``lax.scan`` and leaves as a list of ``L``
    per-step dicts."""
    dev = resolve_device(torch_device)

    def conv(node, step=None):
        if isinstance(node, Mapping):
            return {k: conv(v, step) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v, step) for v in node]
        a = np.asarray(node, np.float32)
        a = a if step is None else a[step]
        return torch.from_numpy(np.array(a)).to(dev, cfg.pdtype)

    out = {k: conv(v) for k, v in tree.items() if k != "proc"}
    if "proc" in tree:
        out["proc"] = [conv(tree["proc"], i) for i in range(cfg.n_layers)]
    return out


# ----------------------------- training -------------------------------- #
def _tensor(a, dev: torch.device) -> torch.Tensor:
    """A numpy array (bf16 ones as ``ml_dtypes`` arrays, read through their
    uint16 bits) as a tensor of the same dtype on ``dev``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a, order="C").view(np.int16)).view(
            torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(a)).to(dev)


def _array(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy; bf16 becomes float32 (exactly)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _unstack(tree, n_layers: int, fn, stacked: str = "layers"):
    """``fn`` over every array of a reference tree (dicts and lists kept),
    the subtree under ``stacked`` (an LM's ``layers``, MeshGraphNet's
    ``proc``) split into a list of ``n_layers`` per-layer trees."""
    def conv(node, i=None):
        if isinstance(node, Mapping):
            return {k: conv(v, i) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v, i) for v in node]
        return fn(node if i is None else np.asarray(node)[i])

    out = {k: conv(v) for k, v in tree.items() if k != stacked}
    if stacked in tree:
        out[stacked] = [conv(tree[stacked], i) for i in range(n_layers)]
    return out


def lm_train_params_from_arrays(tree: Mapping, cfg, torch_device="cuda"):
    """The port's float32 master params (the layers a per-layer list) on
    ``torch_device`` from the reference's ``init`` tree of a dense or MoE
    LM as numpy arrays (layers stacked ``[L, ...]``), each leaf kept in its
    own dtype: no serving cast."""
    return tree_from_arrays(tree, cfg.n_layers, torch_device)


def lm_tree_to_arrays(tree):
    """A port LM tree (params, gradients or AdamW moments: the layers a
    per-layer list) in the reference's layout as numpy arrays: every layer
    leaf stacked ``[L, ...]``; bf16 leaves as float32."""
    out = {k: _array(v) for k, v in tree.items() if k != "layers"}
    if "layers" in tree:
        layers = tree["layers"]
        out["layers"] = {k: np.stack([_array(lp[k]) for lp in layers])
                         for k in layers[0]} if layers else {}
    return out


def tree_from_arrays(tree: Mapping, n_layers: int = 0, torch_device="cuda",
                     stacked: str = "layers"):
    """Any reference tree of numpy arrays (a flat dict such as the FM's, an
    LM's with stacked ``layers``, a GNN's with lists of matrices and
    MeshGraphNet's stacked ``proc``: ``stacked="proc"``) as the port's tree
    of tensors on ``torch_device``, each leaf in its own dtype."""
    dev = resolve_device(torch_device)
    return _unstack(tree, n_layers, lambda a: _tensor(a, dev), stacked)


def adamw_state_from_arrays(step, mu: Mapping, nu: Mapping, n_layers: int = 0,
                            torch_device="cuda", stacked: str = "layers"):
    """The port's ``AdamWState`` from the reference's ``(step, mu, nu)`` as
    numpy arrays (bf16 moments as ``ml_dtypes`` arrays); ``n_layers`` for
    moments that stack their layers under ``stacked`` (an LM's ``layers``,
    MeshGraphNet's ``proc``)."""
    from repro_torch.optim.optimizers import AdamWState

    dev = resolve_device(torch_device)
    return AdamWState(step=torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                                        device=dev),
                      mu=tree_from_arrays(mu, n_layers, dev, stacked),
                      nu=tree_from_arrays(nu, n_layers, dev, stacked))


def adamw_state_to_arrays(state) -> dict:
    """``{"step": int, "mu", "nu"}`` of a port ``AdamWState`` in the
    reference's layout (:func:`lm_tree_to_arrays`; bf16 as float32)."""
    return {"step": int(state.step), "mu": lm_tree_to_arrays(state.mu),
            "nu": lm_tree_to_arrays(state.nu)}


def data_cursor(state: Mapping) -> dict:
    """A data stream's cursor (``TokenStream``, ``RecsysStream``,
    ``NeighborSampler``, ``GraphBatcher``: ``state()``) in the form both
    packages' ``restore`` read: ``{"seed": int, "step": int}``."""
    return {"seed": int(state["seed"]), "step": int(state["step"])}

"""Partition specs per architecture family.

A spec is a :class:`Spec`: a tuple with one entry per tensor dimension,
each ``None`` (replicated), a mesh-axis name, or a tuple of axis names
(that dimension split over their flattened product, the first axis
major) — the content of the reference's ``PartitionSpec``.  Spec trees
follow the reference's param trees (an LM's layers stacked, the layer
dimension first).  :func:`placements` turns a spec into DTensor
placements on a mesh.

Mesh axes: ``("data", "model")`` single-pod, ``("pod", "data", "model")``
multi-pod; ``dp_axes`` is ``("data",)`` or ``("pod", "data")``.

* LM (dense and MoE), FSDP x TP: the fsdp axis (the dp axes) splits the
  d_model rows of every matmul weight, the model axis its head / ff
  columns; the vocab over model for the embedding and unembedding.
* GNN: edges over the dp axes, node state replicated (full batch) or
  split over dp (sampled).
* RecSys: embedding tables row-split over model, the batch over dp.
* Optimizer state: moments split like their param; Adafactor's row and
  column factors drop the reduced dimension; scalars replicate.

The step builders (:mod:`repro_torch.launch.steps`) apply them over a
``DeviceMesh``: each rank's pieces become DTensors at :func:`placements`.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple


class Spec(tuple):
    """One tensor's partition spec: ``Spec(None, "data", ("pod", "data"))``."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def map_specs(fn: Callable[[Spec], Any], tree):
    """``fn`` over the :class:`Spec` leaves of a tree of dicts, lists and
    named tuples."""
    if isinstance(tree, Spec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[map_specs(fn, v) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_specs(fn, v) for v in tree)
    return tree


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes one spec entry names, major first (``None``: none)."""
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: Spec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dimension:
    ``Shard(i)`` where the dimension names an axis of tensor dim ``i``,
    else ``Replicate()``.  Several axes on one tensor dim shard it in the
    mesh's dimension order, so a spec's axis tuple must list them in that
    order (the reference's is major first)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names or ())
    out = [Replicate() for _ in names]
    for i, entry in enumerate(spec):
        axes = entry_axes(entry)
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec} names axis {a!r}; the mesh has {names}")
            out[names.index(a)] = Shard(i)
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"spec {spec}: axes {axes} out of the mesh's order {names}")
    return out


def _fsdp(dp_axes: Tuple[str, ...]):
    return dp_axes if len(dp_axes) > 1 else dp_axes[0]


def lm_param_specs(cfg, dp_axes: Tuple[str, ...] = ("data",), fsdp: bool = True):
    """Spec tree matching the reference's ``transformer.init`` / ``moe.init``
    trees (layers stacked, the layer dimension first)."""
    f = _fsdp(dp_axes) if fsdp else None
    layer = {
        "ln1": Spec(None),
        "ln2": Spec(None),
        "wq": Spec(None, f, "model"),
        "wk": Spec(None, f, "model"),
        "wv": Spec(None, f, "model"),
        "wo": Spec(None, "model", f),
        "w_gate": Spec(None, f, "model"),
        "w_up": Spec(None, f, "model"),
        "w_down": Spec(None, "model", f),
    }
    if getattr(cfg, "qk_norm", False):
        layer["q_norm"] = Spec(None)
        layer["k_norm"] = Spec(None)
    specs = {"embed": Spec("model", f), "layers": layer, "ln_f": Spec(None)}
    if not cfg.tie_embeddings:
        specs["unembed"] = Spec(f, "model")
    return specs


def moe_param_specs(cfg, dp_axes: Tuple[str, ...] = ("data",), fsdp: bool = True,
                    expert_parallel: bool = False):
    """:func:`lm_param_specs` with the dense FFN replaced by the router and
    the experts: experts over model (``expert_parallel``; the padded expert
    count a multiple of the model axis) or TP inside each expert's FFN."""
    f = _fsdp(dp_axes) if fsdp else None
    base = lm_param_specs(cfg, dp_axes, fsdp)
    layer = dict(base["layers"])
    for k in ("w_gate", "w_up", "w_down"):
        layer.pop(k, None)
    if expert_parallel:
        layer.update(router=Spec(None, f, None), we_gate=Spec(None, "model", f, None),
                     we_up=Spec(None, "model", f, None),
                     we_down=Spec(None, "model", None, f))
    else:
        layer.update(router=Spec(None, f, None), we_gate=Spec(None, None, f, "model"),
                     we_up=Spec(None, None, f, "model"),
                     we_down=Spec(None, None, "model", f))
    if cfg.n_shared_experts:
        layer.update(ws_gate=Spec(None, f, "model"), ws_up=Spec(None, f, "model"),
                     ws_down=Spec(None, "model", f))
    base["layers"] = layer
    return base


def lm_batch_specs(dp_axes: Tuple[str, ...] = ("data",)):
    d = _fsdp(dp_axes)
    return {"tokens": Spec(d, None), "labels": Spec(d, None)}


def kv_cache_specs(dp_axes: Tuple[str, ...] = ("data",), seq_axis: str = "model"):
    """KV cache ``[L, B, Hkv, S, D]``: batch over dp, sequence over
    ``seq_axis``."""
    d = _fsdp(dp_axes)
    return {"k": Spec(None, d, None, seq_axis, None),
            "v": Spec(None, d, None, seq_axis, None)}


def gnn_specs(dp_axes: Tuple[str, ...] = ("data",)):
    d = _fsdp(dp_axes)
    return {"edges": Spec(d), "nodes": Spec(None), "node_batch": Spec(d)}


def recsys_specs(dp_axes: Tuple[str, ...] = ("data",)):
    d = _fsdp(dp_axes)
    return {"emb": Spec("model", None), "w1": Spec("model"), "bias": Spec(),
            "batch": Spec(d, None)}


def opt_state_specs(param_specs, opt_state):
    """The optimizer state's spec tree for the port's ``AdamWState``,
    ``SGDState`` or ``AdafactorState`` (only its type is read)."""
    from repro_torch.optim.optimizers import AdafactorState, AdamWState, SGDState

    if isinstance(opt_state, AdamWState):
        return AdamWState(step=Spec(), mu=param_specs, nu=param_specs)
    if isinstance(opt_state, SGDState):
        return SGDState(step=Spec(), momentum=param_specs)
    if isinstance(opt_state, AdafactorState):
        def drop(spec, which):
            if len(spec) < 2:
                return Spec()
            return Spec(*(spec[:-1] if which == "row" else spec[:-2] + spec[-1:]))

        return AdafactorState(step=Spec(),
                              row=map_specs(lambda s: drop(s, "row"), param_specs),
                              col=map_specs(lambda s: drop(s, "col"), param_specs),
                              full=map_specs(lambda s: Spec(), param_specs))
    raise TypeError(type(opt_state))

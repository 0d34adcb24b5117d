"""Activation layouts: where a step over a mesh anchors its activations.

The reference hands GSPMD sharding hints at the few places that fix the
layout (``with_sharding_constraint``).  Here an activation on a mesh is a
DTensor, and :func:`constrain` redistributes it to the layout its name
asks for: the collective that moves it there (an all-gather, a
reduce-scatter, an all-reduce of a partial sum) is DTensor's, and so is
its backward.  The model functions take an ``acts`` dict of named
:class:`~repro_torch.distributed.sharding_rules.Spec`\\ s and call
:func:`constrain` at the reference's places:

* ``res`` — the residual stream [B, S, D]: ``Spec(dp, "model", None)``,
  sequence parallelism (S divides the model axis for every assigned
  shape, unlike head counts);
* ``logits`` — [B, S, V] or [B, V]: vocab over ``"model"``;
* ``loss_hidden`` / ``loss_logits`` — the fused loss's hidden states
  (gathered over ``"model"``) and its per-chunk logits (vocab over
  ``"model"``);
* ``moe_shard`` — ``(mesh, dp_axes, "model")``: the MoE feed-forward's
  expert-TP branch (``models/moe.py``).

``constrain(x, acts, name)`` is the identity when ``acts`` is None, when
the name is absent, and on a plain tensor (one card, or a mesh of one
device, where a step runs plain tensors).
"""

from __future__ import annotations

from typing import Dict, Optional

from repro_torch.distributed.sharding_rules import Spec, _fsdp, placements


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor (an activation or param over a mesh)."""
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def constrain(x, acts: Optional[Dict], name: str):
    """``x`` redistributed to the layout ``acts[name]`` names (a DTensor);
    ``x`` itself otherwise."""
    if acts is None:
        return x
    spec = acts.get(name)
    if spec is None or not is_dtensor(x):
        return x
    return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))


def _acts(dp_axes, mesh, specs: Dict) -> Dict:
    if mesh is not None:
        specs["moe_shard"] = (mesh, tuple(dp_axes), "model")
    return specs


def lm_train_acts(dp_axes, mesh=None) -> Dict:
    d = _fsdp(tuple(dp_axes))
    return _acts(dp_axes, mesh, {
        "res": Spec(d, "model", None),
        "logits": Spec(d, None, "model"),  # vocab over model
        "loss_hidden": Spec(d, None, None),  # gathered over model for the head
        "loss_logits": Spec(d, None, "model"),  # per-chunk logits, vocab over model
    })


def lm_prefill_acts(dp_axes, mesh=None) -> Dict:
    d = _fsdp(tuple(dp_axes))
    return _acts(dp_axes, mesh, {
        "res": Spec(d, "model", None),
        "logits": Spec(d, "model"),  # [B, V] last-token logits
    })


def lm_decode_acts(dp_axes, mesh=None) -> Dict:
    d = _fsdp(tuple(dp_axes))
    return _acts(dp_axes, mesh, {
        "res": Spec(d, None, None),  # [B, 1, D]
        "logits": Spec(d, "model"),
    })

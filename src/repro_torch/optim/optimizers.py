"""Optimizer stack (optax-style pure transforms) over trees of tensors.

As in the reference:

* **AdamW with bf16 moments** (``moment_dtype=torch.bfloat16``): the state
  is stored in bf16 and upcast for the update math, so the trajectory
  error is bounded by bf16 rounding of the *state*, not of the *update*;
  ``c1 = 1 - b1**t`` in float32, weight decay on the float32 param.
* **Adafactor**: factored second moments (row / column) for matrices.
* Global-norm clipping fused into the update; the norm is taken over every
  leaf in float32, summed in the reference's leaf order.

Every transform is a pure function: ``update(grads, state, params)``
returns new params and a new state, leaf by leaf, and leaves its inputs as
they were.  Grads, params and state are trees (:mod:`repro_torch.tree`);
the step counter is a 0-d int32 tensor on the params' device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.tree import leaves, tree_map, unflatten


class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: Any  # tree like params (moment_dtype)
    nu: Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any, torch.Tensor]]  # (grads, state, params)


def _device(params) -> torch.device:
    ls = leaves(params)
    return ls[0].device if ls else torch.device("cpu")


def _zero_step(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=_device(params))


def _lr_fn(lr):
    if callable(lr):
        return lr
    return lambda step: torch.tensor(lr, dtype=torch.float32, device=step.device)


def _global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    norm = _global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def _clip(grads, clip_norm):
    if clip_norm is not None:
        return clip_by_global_norm(grads, clip_norm)
    return grads, _global_norm(grads)


def _pick(tree, outs, i):
    return unflatten(tree, [o[i] for o in outs])


def adamw(
    lr: Callable[[torch.Tensor], torch.Tensor] | float,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    moment_dtype=torch.bfloat16,
    clip_norm: Optional[float] = 1.0,
) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=moment_dtype, device=p.device)

        return AdamWState(step=_zero_step(params), mu=tree_map(zeros, params),
                          nu=tree_map(zeros, params))

    @torch.no_grad()
    def update(grads, state, params):
        grads, gnorm = _clip(grads, clip_norm)
        step = state.step + 1
        t = step.to(torch.float32)
        c1 = 1.0 - b1 ** t
        c2 = 1.0 - b2 ** t
        lr_t = lr_fn(step)

        def upd(g, m, v, p):
            g32 = g.to(torch.float32)
            m32 = b1 * m.to(torch.float32) + (1 - b1) * g32
            v32 = b2 * v.to(torch.float32) + (1 - b2) * g32 * g32
            mhat = m32 / c1
            vhat = v32 / c2
            delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.to(torch.float32)
            return ((p.to(torch.float32) - lr_t * delta).to(p.dtype),
                    m32.to(moment_dtype), v32.to(moment_dtype))

        outs = [upd(*xs) for xs in zip(leaves(grads), leaves(state.mu),
                                       leaves(state.nu), leaves(params))]
        return (_pick(params, outs, 0),
                AdamWState(step=step, mu=_pick(state.mu, outs, 1),
                           nu=_pick(state.nu, outs, 2)),
                gnorm)

    return Optimizer(init=init, update=update)


def _like(x, ref):
    """``x`` at ``ref``'s layout when both are DTensors (a factored moment
    reduced over a split dimension comes back a partial sum, and the update
    lands at the param's layout); ``x`` otherwise."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor) and isinstance(ref, DTensor) \
            and tuple(x.placements) != tuple(ref.placements):
        return x.redistribute(ref.device_mesh, ref.placements)
    return x


class AdafactorState(NamedTuple):
    step: torch.Tensor
    row: Any
    col: Any
    full: Any  # for <2D params


def adafactor(
    lr: Callable | float = 1e-3,
    decay: float = 0.8,
    eps: float = 1e-30,
    clip_norm: Optional[float] = 1.0,
) -> Optimizer:
    """Factored second-moment optimizer (Shazeer & Stern): O(rows + cols)
    state for matrices."""
    lr_fn = _lr_fn(lr)

    def init(params):
        def z(shape, p):
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        def rowcol(p):
            if p.dim() >= 2:
                return (z(p.shape[:-1], p), z(p.shape[:-2] + p.shape[-1:], p), z((1,), p))
            return (z((1,), p), z((1,), p), z(p.shape, p))

        trips = [rowcol(p) for p in leaves(params)]
        return AdafactorState(_zero_step(params), _pick(params, trips, 0),
                              _pick(params, trips, 1), _pick(params, trips, 2))

    @torch.no_grad()
    def update(grads, state, params):
        grads, gnorm = _clip(grads, clip_norm)
        step = state.step + 1
        beta = 1.0 - (step.to(torch.float32) + 1.0) ** (-decay)
        lr_t = lr_fn(step)

        def upd(g, r, c, f, p):
            g32 = g.to(torch.float32)
            if p.dim() >= 2:
                r2 = _like(beta * r + (1 - beta) * torch.mean(g32 * g32, dim=-1), r)
                c2 = _like(beta * c + (1 - beta) * torch.mean(g32 * g32, dim=-2), c)
                rmean = torch.mean(r2, dim=-1, keepdim=True)
                v = (r2[..., None] * c2[..., None, :]) / torch.clamp(rmean[..., None], min=eps)
                delta = _like(g32 / torch.clamp(torch.sqrt(v), min=eps), p)
                return ((p.to(torch.float32) - lr_t * delta).to(p.dtype), r2, c2, f)
            f2 = beta * f + (1 - beta) * g32 * g32
            delta = g32 / torch.clamp(torch.sqrt(f2), min=eps)
            return ((p.to(torch.float32) - lr_t * delta).to(p.dtype), r, c, f2)

        outs = [upd(*xs) for xs in zip(leaves(grads), leaves(state.row), leaves(state.col),
                                       leaves(state.full), leaves(params))]
        return (_pick(params, outs, 0),
                AdafactorState(step, _pick(state.row, outs, 1), _pick(state.col, outs, 2),
                               _pick(state.full, outs, 3)),
                gnorm)

    return Optimizer(init=init, update=update)


class SGDState(NamedTuple):
    step: torch.Tensor
    momentum: Any


def sgd(lr: Callable | float = 1e-2, momentum: float = 0.9,
        clip_norm: Optional[float] = None) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        return SGDState(_zero_step(params), tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params))

    @torch.no_grad()
    def update(grads, state, params):
        grads, gnorm = _clip(grads, clip_norm)
        step = state.step + 1
        lr_t = lr_fn(step)

        def upd(g, m, p):
            m2 = momentum * m + g.to(torch.float32)
            return ((p.to(torch.float32) - lr_t * m2).to(p.dtype), m2)

        outs = [upd(*xs) for xs in zip(leaves(grads), leaves(state.momentum),
                                       leaves(params))]
        return _pick(params, outs, 0), SGDState(step, _pick(state.momentum, outs, 1)), gnorm

    return Optimizer(init=init, update=update)


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)

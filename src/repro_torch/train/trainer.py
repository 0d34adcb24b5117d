"""Trainer: the step, microbatch accumulation, checkpoints and FT hooks.

The reference's ``Trainer`` on PyTorch, run eagerly:

* gradient accumulation (microbatching): each step takes ``microbatch``
  batches of the stream in order, sums their float32 gradients and divides
  by the count (the loss is the mean over them), so it means one batch of
  that many rows;
* deterministic resume (params, optimizer state, error feedback, data
  cursor and step) to an identical loss trajectory after a preemption;
* optional int8 gradient compression with error feedback, applied to the
  averaged gradients before the optimizer's update;
* straggler watchdog events.

``loss_fn(params, batch)`` takes the params tree and a dict of tensors on
the params' device (the stream's NumPy arrays, uploaded) and returns a
scalar; gradients come from ``torch.autograd.grad`` with respect to every
floating-point leaf (zeros for a leaf the loss does not reach, as JAX
gives).  History entries are ``{step, loss, gnorm, dt}``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.optim.grad_compress import init_error_feedback, int8_compress_hook
from repro_torch.optim.optimizers import Optimizer
from repro_torch.train.checkpoints import CheckpointManager
from repro_torch.train.fault_tolerance import FaultToleranceMonitor
from repro_torch.tree import leaves, unflatten


@dataclasses.dataclass
class TrainConfig:
    total_steps: int = 100
    microbatch: int = 1  # gradient-accumulation chunks per step
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    grad_compression: bool = False
    log_every: int = 10


def value_and_grad(loss_fn: Callable, params, batch):
    """(loss, grads): ``loss_fn(params, batch)`` and its gradient with
    respect to every floating-point leaf of ``params`` (a tree like it)."""
    live = [p.detach().requires_grad_(p.is_floating_point()) for p in leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(unflatten(params, live), batch)
        wrt = [p for p in live if p.requires_grad]
        got = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
    grads = []
    for p in live:
        g = next(got) if p.requires_grad else None
        grads.append(torch.zeros_like(p) if g is None else g)
    return loss.detach(), unflatten(params, grads)


class Trainer:
    def __init__(
        self,
        loss_fn: Callable,  # (params, batch) -> scalar
        optimizer: Optimizer,
        params,
        data,  # stream with .next()/.state()/.restore()
        cfg: TrainConfig,
        monitor: Optional[FaultToleranceMonitor] = None,
    ):
        self.loss_fn = loss_fn
        self.opt = optimizer
        self.params = params
        self.opt_state = optimizer.init(params)
        self.data = data
        self.cfg = cfg
        self.monitor = monitor or FaultToleranceMonitor()
        self.step = 0
        self.history: list = []
        self.err_fb = init_error_feedback(params) if cfg.grad_compression else None
        self.ckpt = (
            CheckpointManager(cfg.checkpoint_dir) if cfg.checkpoint_dir else None
        )
        self.device = leaves(params)[0].device

    # ------------------------------------------------------------------ #
    def _upload(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                if isinstance(v, np.ndarray) else v for k, v in batch.items()}

    def _step_impl(self, params, opt_state, err_fb, batches):
        """batches: the step's microbatches, in order."""
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        acc = None
        for mb in batches:
            loss, grads = value_and_grad(self.loss_fn, params, mb)
            loss_sum = loss_sum + loss
            g32 = [g.to(torch.float32) for g in leaves(grads)]
            acc = g32 if acc is None else [a + g for a, g in zip(acc, g32)]
            del loss, grads, g32
        nmb = len(batches)
        grads = unflatten(params, [a / nmb for a in acc])
        del acc
        if err_fb is not None:
            grads, err_fb = int8_compress_hook(grads, err_fb)
        params, opt_state, gnorm = self.opt.update(grads, opt_state, params)
        return params, opt_state, err_fb, loss_sum / nmb, gnorm

    def _microbatches(self):
        return [self._upload(self.data.next()) for _ in range(self.cfg.microbatch)]

    # ------------------------------------------------------------------ #
    def run(self, steps: Optional[int] = None) -> Dict[str, Any]:
        steps = steps if steps is not None else self.cfg.total_steps
        target = self.step + steps
        while self.step < target:
            if self.monitor.should_stop:  # preempted before starting a step
                break
            t0 = time.perf_counter()
            batches = self._microbatches()
            (self.params, self.opt_state, self.err_fb, loss, gnorm) = self._step_impl(
                self.params, self.opt_state, self.err_fb, batches
            )
            self.step += 1
            loss, gnorm = float(loss), float(gnorm)  # waits for the step
            dt = time.perf_counter() - t0
            self.monitor.observe_step(self.step, dt)
            self.history.append({"step": self.step, "loss": loss, "gnorm": gnorm, "dt": dt})
            if self.ckpt and self.step % self.cfg.checkpoint_every == 0:
                self.save()
            if self.monitor.should_stop:
                if self.ckpt:
                    self.save()
                break
        return {"step": self.step, "history": self.history}

    # ------------------------------------------------------------------ #
    def _state(self):
        state = {"params": self.params, "opt": self.opt_state}
        if self.err_fb is not None:
            state["err_fb"] = self.err_fb
        return state

    def save(self):
        extra = {"data": self.data.state(), "step": self.step}
        self.ckpt.save(self.step, self._state(), extra)

    def resume(self, shardings=None):
        state, extra, step = self.ckpt.restore(self._state(), shardings=shardings)
        self.params = state["params"]
        self.opt_state = state["opt"]
        if self.err_fb is not None:
            self.err_fb = state["err_fb"]
        self.data.restore(extra["data"])
        self.step = int(extra["step"])
        self.monitor.note_restart()
        return step

"""End-to-end training driver.

``python -m repro_torch.launch.train --arch qwen3-0.6b`` trains the chosen
arch's reduced SMOKE config on the card for ``--steps`` steps, with
checkpointing and fault-tolerance monitoring, as the reference's
``repro.launch.train`` does (``--device cpu`` runs it on the CPU).
:func:`build_trainer` with ``smoke=False`` takes the full config.  The dense LMs train through
``transformer.loss_fn``, the MoE archs through ``moe.loss_fn`` and the FM
through ``recsys.loss_fn``; GNN archs raise, as in the reference (they
train through :func:`repro_torch.launch.steps.build_gnn_train`).

Params are the float32 masters (``init_master``) drawn from a
``torch.Generator`` seeded with 0 on the device; the data streams are the
reference's, keyed by (seed, step).  ``torch_device="cpu"`` runs it on the
CPU (the kernels' plain versions); the default is the card, and without
one it raises.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.data.pipeline import RecsysStream, TokenStream
from repro_torch.device import resolve_device
from repro_torch.models import moe as MoE
from repro_torch.models import recsys as R
from repro_torch.models import transformer as T
from repro_torch.optim.optimizers import adamw
from repro_torch.optim.schedules import cosine_schedule
from repro_torch.train.fault_tolerance import FaultToleranceMonitor
from repro_torch.train.trainer import TrainConfig, Trainer


def build_trainer(arch_name: str, *, smoke: bool = True, batch: int = 8,
                  seq: int = 64, steps: int = 100, ckpt_dir=None,
                  microbatch: int = 1, grad_compression: bool = False,
                  torch_device="cuda", cfg=None) -> Trainer:
    """The reference's ``build_trainer`` on the port.  ``cfg`` replaces the
    arch's config (e.g. one with its depth cut)."""
    dev = resolve_device(torch_device)
    arch = get_arch(arch_name)
    if cfg is None:
        cfg = arch.smoke_cfg if smoke else arch.model_cfg
    gen = torch.Generator(device=dev).manual_seed(0)
    if arch.family in ("lm-dense", "lm-moe"):
        mod = MoE if isinstance(cfg, MoE.MoEConfig) else T
        params = mod.init_master(gen, cfg)
        data = TokenStream(vocab=cfg.vocab, batch=batch, seq=seq)

        def loss(p, b):
            return mod.loss_fn(p, b, cfg)
    elif arch.family == "recsys":
        params = R.init(gen, cfg)
        data = RecsysStream(n_fields=cfg.n_fields, batch=batch)

        def loss(p, b):
            return R.loss_fn(p, b, cfg)
    elif arch.family == "gnn":
        raise ValueError(f"{arch_name}: GNN archs train through "
                         "repro_torch.launch.steps.build_gnn_train, not build_trainer")
    else:
        raise ValueError(f"{arch_name}: the {arch.family!r} family has no training step")
    opt = adamw(cosine_schedule(3e-4, 20, max(steps, 21)))
    tc = TrainConfig(
        total_steps=steps,
        microbatch=microbatch,
        checkpoint_every=max(steps // 4, 1),
        checkpoint_dir=ckpt_dir,
        grad_compression=grad_compression,
    )
    return Trainer(loss, opt, params, data, tc, FaultToleranceMonitor())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    tr = build_trainer(
        args.arch, smoke=True, batch=args.batch, seq=args.seq,
        steps=args.steps, ckpt_dir=args.ckpt_dir, microbatch=args.microbatch,
        grad_compression=args.grad_compression, torch_device=args.device,
    )
    out = tr.run()
    first, last = out["history"][0]["loss"], out["history"][-1]["loss"]
    print(json.dumps({"steps": out["step"], "loss_first": first, "loss_last": last}))
    assert np.isfinite(last)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Entry point for the FM interaction: the kernel (K4) on CUDA tensors,
its plain version on CPU tensors."""

from __future__ import annotations

import torch

from repro_torch.kernels.build import plain_route
from repro_torch.kernels.fm_interaction.fm_interaction import (
    fm_interaction,
    fm_interaction_train,
)


def fm_second_order(emb):
    """emb: [B, F, K] -> [B].  Launches K4 for a CUDA tensor (or raises);
    a CPU tensor takes the plain version.  On the card a call that autograd
    records (grad mode on, ``emb`` requiring grad: training) takes K4 with
    its backward kernel."""
    emb = emb.float().contiguous()
    if not plain_route(emb) and torch.is_grad_enabled() and emb.requires_grad:
        return fm_interaction_train(emb)
    return fm_interaction(emb)

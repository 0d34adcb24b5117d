"""Entry point for the FM interaction: the kernel (K4) on CUDA tensors,
its plain version on CPU tensors."""

from __future__ import annotations

from repro_torch.kernels.fm_interaction.fm_interaction import fm_interaction


def fm_second_order(emb):
    """emb: [B, F, K] -> [B].  Launches K4 for a CUDA tensor (or raises);
    a CPU tensor takes the plain version."""
    return fm_interaction(emb.float().contiguous())

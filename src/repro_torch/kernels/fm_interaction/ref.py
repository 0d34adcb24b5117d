"""Oracle for the FM second-order interaction (Rendle, ICDM'10).

``y[b] = 0.5 * sum_k ( (sum_f v[b,f,k])^2 - sum_f v[b,f,k]^2 )``

— the O(n*k) sum-square factorization of the pairwise dot interactions.
"""

from __future__ import annotations

import torch


def fm_interaction_ref(emb: torch.Tensor) -> torch.Tensor:
    """emb: [B, F, K] field embeddings (already weighted by feature value).
    Returns [B] second-order interaction."""
    s = emb.sum(dim=1)  # [B, K]
    ss = (emb * emb).sum(dim=1)  # [B, K]
    return 0.5 * (s * s - ss).sum(dim=-1)

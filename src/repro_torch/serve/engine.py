"""Batched serving engine (continuous-batching-lite).

Request lifecycle: a batched prefill of the prompts (right-padded with
token 0 to the longest) -> token-by-token greedy batched decode against a
preallocated KV cache -> detach at max-tokens.  The engine serves the
last prompt position's logits and masks no padding: the reference's
semantics, copied.

The cache contract is zero-initialized free space (see
``transformer.cache_update_add``); the decode steps write it in place.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # int32 [S]
    max_new: int = 16
    out: Optional[np.ndarray] = None


class ServeEngine:
    def __init__(self, params, cfg, module, max_seq: int = 256, slots: int = 8):
        """module: the model's module, :mod:`repro_torch.models.transformer`
        or :mod:`repro_torch.models.moe` (its ``prefill`` and
        ``decode_step``).  Runs on the device the params lie on."""
        self.params = params
        self.cfg = cfg
        self.mod = module
        self.max_seq = max_seq
        self.slots = slots
        self.device = params["embed"].device

    def generate(self, requests: List[Request]) -> Dict[int, np.ndarray]:
        """Batched greedy generation for <= slots requests."""
        if len(requests) > self.slots:
            raise ValueError(f"{len(requests)} requests for {self.slots} slots")
        live = list(requests)
        plen = max(r.prompt.size for r in live)
        prompts = np.zeros((len(live), plen), np.int32)
        for i, r in enumerate(live):
            prompts[i, : r.prompt.size] = r.prompt
        kv, logits = self.mod.prefill(
            self.params, torch.from_numpy(prompts).to(self.device), self.cfg)
        # grow the cache to max_seq (zero-initialized free space)
        kv = {k: F.pad(v, (0, 0, 0, self.max_seq - plen)) for k, v in kv.items()}
        outs = [[] for _ in live]
        tok = logits.argmax(dim=-1)
        max_new = max(r.max_new for r in live)
        for step in range(max_new):
            toks = tok.tolist()
            for i, r in enumerate(live):
                if step < r.max_new:
                    outs[i].append(toks[i])
            pos = plen + step
            if pos >= self.max_seq - 1 or step == max_new - 1:
                break
            logits, kv = self.mod.decode_step(self.params, tok, kv, pos, self.cfg)
            tok = logits.argmax(dim=-1)
        return {r.rid: np.array(o[: r.max_new], np.int32) for r, o in zip(live, outs)}

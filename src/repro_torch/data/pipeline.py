"""Deterministic, resumable data pipelines.

Every stream is keyed by ``(seed, step)`` — restoring a checkpoint with the
same cursor reproduces the exact batch sequence (the fault-tolerance
contract in :mod:`repro_torch.train.fault_tolerance`).  Host-side NumPy only; the
device step receives plain arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.core.graph import Graph


@dataclasses.dataclass
class TokenStream:
    """Synthetic LM token stream (zipfian unigram over the vocab)."""

    vocab: int
    batch: int
    seq: int
    seed: int = 0
    step: int = 0  # cursor — checkpointed

    def next(self) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, self.step))
        ranks = rng.zipf(1.2, size=(self.batch, self.seq)).astype(np.int64)
        tokens = (ranks % self.vocab).astype(np.int32)
        self.step += 1
        return {"tokens": tokens, "labels": tokens}

    def state(self):
        return {"seed": self.seed, "step": self.step}

    def restore(self, state):
        self.seed, self.step = int(state["seed"]), int(state["step"])


@dataclasses.dataclass
class RecsysStream:
    """Criteo-shaped click stream: sparse ids + bernoulli labels."""

    n_fields: int
    batch: int
    seed: int = 0
    step: int = 0

    def next(self) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, self.step))
        x = rng.integers(0, 2**31 - 1, size=(self.batch, self.n_fields), dtype=np.int64)
        y = (rng.random(self.batch) < 0.25).astype(np.float32)
        self.step += 1
        return {"x": x.astype(np.int32), "y": y}

    def state(self):
        return {"seed": self.seed, "step": self.step}

    def restore(self, state):
        self.seed, self.step = int(state["seed"]), int(state["step"])


class NeighborSampler:
    """GraphSAGE-style layered neighbor sampler (minibatch_lg shape).

    Produces a padded subgraph: target nodes + `fanouts` rings, with edges
    (src -> dst) pointing from sampled neighbors into the previous ring.
    Padded entries point at the sink id ``sub_n``.
    """

    def __init__(self, g: Graph, fanouts=(15, 10), seed: int = 0):
        self.g = g
        self.fanouts = tuple(fanouts)
        self.seed = seed
        self.step = 0

    def sample(self, batch_nodes: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, self.step))
        self.step += 1
        g = self.g
        targets = rng.integers(0, g.n, size=batch_nodes).astype(np.int32)
        # ring 0 = targets; ring r+1 = fanout-sampled neighbors of ring r
        rings = [targets]
        edges_src, edges_dst = [], []
        node_list = [targets]
        offset = 0
        next_offset = batch_nodes
        for fan in self.fanouts:
            prev = rings[-1]
            nbrs = np.empty((prev.size, fan), dtype=np.int32)
            for i, v in enumerate(prev):
                nb = g.out_neighbors(int(v))
                if nb.size == 0:
                    nbrs[i] = v
                else:
                    nbrs[i] = nb[rng.integers(0, nb.size, size=fan)]
            flat = nbrs.reshape(-1)
            # local ids: prev ring occupies [offset, offset+prev.size)
            src_local = np.arange(flat.size, dtype=np.int32) + next_offset
            dst_local = np.repeat(
                np.arange(prev.size, dtype=np.int32) + offset, fan
            )
            edges_src.append(src_local)
            edges_dst.append(dst_local)
            node_list.append(flat)
            rings.append(flat)
            offset = next_offset
            next_offset += flat.size
        nodes = np.concatenate(node_list)
        return {
            "node_ids": nodes,  # global ids per local row
            "edge_src": np.concatenate(edges_src),
            "edge_dst": np.concatenate(edges_dst),
            "n_targets": batch_nodes,
            "sub_n": int(nodes.size),
        }

    def state(self):
        return {"seed": self.seed, "step": self.step}

    def restore(self, state):
        self.seed, self.step = int(state["seed"]), int(state["step"])


@dataclasses.dataclass
class GraphBatcher:
    """Full-batch GNN 'stream' (one graph, label mask rotation for epochs)."""

    g: Graph
    d_feat: int
    classes: int
    seed: int = 0
    step: int = 0

    def next(self) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, self.step))
        self.step += 1
        n = self.g.n
        feats = rng.standard_normal((n, self.d_feat), dtype=np.float32)
        labels = rng.integers(0, self.classes, size=n).astype(np.int32)
        mask = (rng.random(n) < 0.1).astype(np.float32)
        src = np.concatenate([self.g.src, self.g.dst]) if not self.g.directed else self.g.src
        dst = np.concatenate([self.g.dst, self.g.src]) if not self.g.directed else self.g.dst
        return {
            "feats": feats,
            "labels": labels,
            "label_mask": mask,
            "edge_src": src.astype(np.int32),
            "edge_dst": dst.astype(np.int32),
        }

    def state(self):
        return {"seed": self.seed, "step": self.step}

    def restore(self, state):
        self.seed, self.step = int(state["seed"]), int(state["step"])

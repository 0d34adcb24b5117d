"""The benchmark's graphs: plain edge arrays made by its own generators.

A configuration's ``generator`` key names a module of ``generators/``
(``wbench/generators/<name>.py``), found by that name; its one entry,
``generate(rng, ...)``, takes the configuration's keys that its signature
names.  The harness hands the edges to the port as
``repro_torch.core.graph.Graph`` and to the reference as they are.
"""

from __future__ import annotations

import dataclasses
import importlib
import inspect
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class EdgeList:
    """``n`` vertices and int32 edges ``src[i] -> dst[i]``; an undirected
    graph stores each edge once."""

    n: int
    src: np.ndarray
    dst: np.ndarray
    directed: bool


def dedupe(src: np.ndarray, dst: np.ndarray, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Drop self-loops and duplicate edges (copied from the port's
    ``graphs/generators.py:_dedupe``)."""
    keep = src != dst
    src, dst = src[keep], dst[keep]
    key = src.astype(np.int64) * n + dst
    _, idx = np.unique(key, return_index=True)
    return src[np.sort(idx)], dst[np.sort(idx)]


def generator(name: str):
    """The ``generate`` function of generator ``name``."""
    return importlib.import_module(f"wbench.generators.{name}").generate


def make_graph(config: dict, rng: np.random.Generator) -> EdgeList:
    """The graph a configuration describes: the generator its ``generator``
    key names, with the configuration's keys that the generator takes."""
    gen = generator(config["generator"])
    names = inspect.signature(gen).parameters
    return gen(rng=rng, **{k: v for k, v in config.items() if k in names and k != "rng"})

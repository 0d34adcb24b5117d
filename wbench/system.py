"""What the window drives: the port's ``Session`` (the system under test),
or, for the check's control, the reference in its place.

Both take the benchmark's own graph and answer ``run_many(vb)`` for a
``[B, n]`` float64 batch with one ``[B, n]`` host array per aggregate, in
the configuration's order.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from wbench import reference


class PortSystem:
    """``repro_torch.core.api.Session`` over the configuration's window, one
    spec per aggregate, each pinned to the configuration's engine.
    ``build_s`` is the host's clock around the ``Session`` build: the index
    and the device plan."""

    def __init__(self, graph, config: dict, device, tracer=None):
        from repro_torch.core import windows
        from repro_torch.core.api import QuerySpec, Session
        from repro_torch.core.graph import Graph

        g = Graph(n=graph.n, src=graph.src, dst=graph.dst, directed=graph.directed)
        spec = config["window"]
        window = getattr(windows, spec["class"])(**spec.get("args", {}))
        opts = dict(config["session"])
        engine = opts.pop("engine")
        specs = [QuerySpec(window, a, engine=engine) for a in config["aggregates"]]
        t = time.perf_counter()
        self.session = Session(g, specs, torch_device=device, tracer=tracer, **opts)
        self.build_s = time.perf_counter() - t

    def run_many(self, vb: np.ndarray) -> list:
        return self.session.run_many(vb)

    def close(self) -> None:
        self.session = None


class ReferenceSystem:
    """The plain reference answering in the program's place, at ``dtype``:
    the check's control at a precision below the configuration's.  It has
    no spans: ``tracer`` is not read."""

    def __init__(self, graph, config: dict, device, tracer=None, dtype=torch.bfloat16):
        t = time.perf_counter()
        self.kind = config["reference"]
        self.aggs = config["aggregates"]
        self.device, self.dtype = device, dtype
        self.prepared = reference.module(self.kind).prepare(
            graph, config["window"].get("args", {}), device)
        self.build_s = time.perf_counter() - t

    def run_many(self, vb: np.ndarray) -> list:
        out = reference.aggregates(self.kind, self.prepared,
                                   torch.from_numpy(vb).to(self.device), self.dtype)
        return [out[a].to(torch.float32).cpu().numpy() for a in self.aggs]

    def close(self) -> None:
        self.prepared = None

"""One run of one cell: inputs from the seed, set-up, the measured window,
an optional traced stretch, then the check against the reference.

The configuration names the graph's generator (``wbench/generators/``),
the mix its loop kind (``wbench/traffic/``); both are found by name.  The
traffic's driver makes its data in set-up, so nothing is made, built or
compiled inside the window.
"""

from __future__ import annotations

import dataclasses
import gc
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from wbench import devprof, graphs, reference, traffic
from wbench.cells import Cell, reader
from wbench.system import PortSystem
from wbench.traffic import Window

#: top-level module names that no run may hold once its window has closed:
#: JAX, its libraries, and the JAX package the port was made from
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")
#: seed streams, one a use, so that each input is the same whatever else
#: the seed draws
VALUES, SAMPLE = 1, 2


@dataclasses.dataclass
class Inputs:
    graph: graphs.EdgeList
    #: the mix's driver, holding the traffic's data made from the seed
    traffic: object
    sample_rng: np.random.Generator
    seconds: float  # spent making them


@dataclasses.dataclass
class Run:
    """What a metric's reader reads."""

    cell: Cell
    batch: int
    n: int
    setup_s: float
    #: set-up's parts in seconds: inputs_s, build_s (the index and the
    #: device plan), warmup_s
    phases: Dict[str, float]
    window: Window
    #: the traced run's host spans from the port's tracer over the window
    spans: Optional[List[dict]] = None
    #: the traced run's profiled stretch after the window
    device: Optional[devprof.DeviceTrace] = None


def rng(seed: int, stream: int) -> np.random.Generator:
    """The generator of one seed stream; any whole number is a seed."""
    return np.random.default_rng(np.random.SeedSequence([seed % (1 << 64), stream]))


def make_inputs(cell: Cell, seed: int) -> Inputs:
    """The configuration's graph, made from its own ``graph_seed`` so that
    every run does the same work, and the traffic's data from the run's
    seed."""
    t = time.perf_counter()
    graph = graphs.make_graph(cell.config, np.random.default_rng(cell.config["graph_seed"]))
    driver = traffic.module(cell.mix["loop"]).make(cell, graph, rng(seed, VALUES))
    return Inputs(graph, driver, rng(seed, SAMPLE), time.perf_counter() - t)


def judge(cell: Cell, inputs: Inputs, win: Window, device) -> Dict[str, dict]:
    """The numbers compared, each with its limit: ``err_max``, the largest
    gap between a kept request's result and the float64 reference rounded
    to the float32 the results are stated in, over every vertex and every
    aggregate; ``failed``, the requests that raised, which never came."""
    cfg = cell.config
    kind, aggs = cfg["reference"], cfg["aggregates"]
    prepared = reference.module(kind).prepare(inputs.graph, cfg["window"].get("args", {}),
                                              device)
    err = 0.0
    refs = {}
    for _, key, res in sorted(win.samples, key=lambda s: s[1]):
        if key not in refs:
            refs.clear()
            vals = torch.from_numpy(inputs.traffic.values(key)).to(device)
            refs[key] = reference.aggregates(kind, prepared, vals, torch.float64)
        for a, got in zip(aggs, res):
            want = refs[key][a].to(torch.float32).to(torch.float64)
            got = torch.as_tensor(np.asarray(got), dtype=torch.float64, device=device)
            if got.shape != want.shape:
                err = float("inf")
                continue
            gap = (got - want).abs().nan_to_num(nan=float("inf"))
            err = max(err, float(gap.max()))
        if len(res) != len(aggs):
            err = float("inf")
    limits = cfg["limits"]
    return {"err_max": {"value": err, "limit": limits["err_max"]},
            "failed": {"value": win.failed, "limit": 0}}


def passed(checks: Dict[str, dict]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def forbidden_modules(names=None) -> List[str]:
    """The forbidden top-level names among ``names`` (``sys.modules`` when
    none are given), compared whole: ``repro_torch`` is not ``repro``."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN_MODULES))


def free_device(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *, device,
             t_start: float, system_class=PortSystem, out=sys.stderr) -> dict:
    """One run of ``cell``; returns the result line's object, with the
    numbers compared under ``checks``, last."""
    device = torch.device(device)
    inputs = make_inputs(cell, seed)
    tracer = None
    if trace:
        from repro_torch.obs.tracing import Tracer

        tracer = Tracer(capacity=1 << 20)
    system = system_class(inputs.graph, cell.config, device, tracer=tracer)
    t = time.perf_counter()
    warm = inputs.traffic.warm_up(system, cell.mix["warmup_requests"])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    warmup_s = time.perf_counter() - t
    gc.collect()
    if tracer is not None:
        tracer.clear()
    setup_s = time.perf_counter() - t_start
    win = inputs.traffic.window(system, seconds, cell.mix["check_requests"],
                                inputs.sample_rng, out=out)
    run = Run(cell, cell.mix["batch"], inputs.graph.n, setup_s,
              {"inputs_s": inputs.seconds, "build_s": system.build_s, "warmup_s": warmup_s},
              win)
    if tracer is not None:
        run.spans = tracer.events()
        if device.type == "cuda":
            run.device = devprof.profile(
                inputs.traffic.profile(system, cell.mix["profile_requests"]), device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    system.close()
    del system
    free_device(device)
    t = time.perf_counter()
    checks = judge(cell, inputs, win, device)
    print("phases " + " ".join(f"{k} {v!r}" for k, v in run.phases.items())
          + f" setup_s {setup_s!r} window_s {win.window_s!r} judge_s {time.perf_counter() - t!r}"
          + f" warmup_requests_s {warm!r}",
          file=out)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    line = {"correct": passed(checks), "attempted": win.attempted, "failed": win.failed,
            "metrics": metrics, "device": dev}
    if run.device is not None:
        dev["busy_s"] = run.device.busy_s()
        dev["window_s"] = (run.device.t1_us - run.device.t0_us) / 1e6
        line["breakdown"] = run.device.breakdown()
    line["checks"] = checks
    return line

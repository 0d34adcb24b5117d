"""Small cells for the benchmark's CPU tests: the configurations and the
mix, cut to a few hundred vertices and batches of eight.

Beside ``BENCHMARK.json``'s cell the tests drive the topological cell that
waits under PERF.md's Open questions (its configuration, reference and
``scan_ms`` reader are in ``wbench/``), so its path stays tested."""

import copy
import dataclasses

import pytest

from wbench import cells

#: vertices of the cut configurations (the DAG keeps a locality below n)
SMALL = {"khop2-er45k": {"n": 400}, "topo-dag60k": {"n": 500, "locality": 40}}
TOPO = "topo-dag60k.batch64"
CELLS = ("khop2-er45k.batch64", TOPO)


def with_topo(bench: dict) -> dict:
    """``bench`` with the topological cell added as a later PR would add it."""
    bench = copy.deepcopy(bench)
    bench["workloads"].append({"name": TOPO, "config": "topo-dag60k", "traffic": "batch64",
                               "chips": 1, "why": "the topological cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and m["name"] != "ell_minmax_ms":  # a DAG's plan has no ELL
            m["workloads"].append(TOPO)
    bench["per_layer"].append({"name": "scan_ms", "unit": "ms", "better": "lower",
                               "source": "device_trace", "layer": "inheritance scan",
                               "moves": "window_results_per_s", "workloads": [TOPO]})
    return bench


@pytest.fixture
def small_cell():
    def make(name: str) -> cells.Cell:
        c = cells.cell(with_topo(cells.benchmark()), name)
        return dataclasses.replace(
            c, config={**c.config, **SMALL[c.config["name"]]},
            mix={**c.mix, "batch": 8, "pool": 4, "warmup_requests": 2,
                 "profile_requests": 4})
    return make

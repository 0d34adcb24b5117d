"""Runs of the benchmark's cells on the CPU at a small size: a sound run
comes out correct, and the control and each planted fault come out not
correct; the result line keeps its schema."""

import json
import time

import pytest

from wbench import faults, harness
from wbench.system import ReferenceSystem

CELLS = ("khop2-er45k.batch64", "topo-dag60k.batch64")
LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run(cell, trace=False, **kw):
    return harness.run_cell(cell, 2**31 + 99, 0.3, trace, device="cpu",
                            t_start=time.perf_counter(), **kw)


def check_schema(line, cell, trace):
    keys = list(line)
    assert keys[:5] == LINE_KEYS and keys[-1] == "checks"
    json.loads(json.dumps(line))  # one JSON object, nothing else
    assert isinstance(line["correct"], bool)
    assert line["attempted"] >= 1 and 0 <= line["failed"] <= line["attempted"]
    dev = line["device"]
    assert set(dev) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert dev["count"] == cell.chips
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    wanted = cell.per_layer if trace else cell.end_to_end
    assert set(line["metrics"]) <= {m["name"] for m in wanted}


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(small_cell, name, trace):
    cell = small_cell(name)
    line = run(cell, trace)
    check_schema(line, cell, trace)
    assert line["correct"], line["checks"]
    assert line["checks"]["err_max"]["value"] == 0.0
    if trace:
        # the spans' readers read on the CPU; the device trace's do not
        assert {"api_host_ms", "query_term_ms", "index_build_s"} <= set(line["metrics"])
        assert "k1_ms" not in line["metrics"] and "breakdown" not in line
    else:
        assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(small_cell, name):
    """The reference in the program's place at bfloat16, the precision below
    the configuration's float32."""
    cell = small_cell(name)
    line = run(cell, system_class=ReferenceSystem)
    assert not line["correct"]
    assert line["checks"]["err_max"]["value"] > 1


@pytest.mark.parametrize("kind", faults.KINDS)
@pytest.mark.parametrize("name", CELLS)
def test_planted_fault_is_not_correct(small_cell, name, kind):
    """Skips the look for a card and drives the rest of a run with the
    timed path broken underneath the Session.  The warm-up goes through the
    fault too, so every request of the window is wrong, the first one
    included."""
    cell = small_cell(name)
    assert cell.mix["warmup_requests"] >= 1
    with faults.planted(kind, cell.config["session"]["engine"]):
        line = run(cell)
    assert line["attempted"] >= 1
    assert not line["correct"], (kind, line["checks"])


def test_failed_request_is_not_correct(small_cell):
    """A request that raises in the window never comes: the run counts it
    failed and is not correct."""
    import io

    cell = small_cell(CELLS[0])

    class FailsAfterWarmup(harness.PortSystem):
        calls = 0

        def run_many(self, vb):
            self.calls += 1
            if self.calls > cell.mix["warmup_requests"]:
                raise RuntimeError("planted")
            return super().run_many(vb)

    line = run(cell, system_class=FailsAfterWarmup, out=io.StringIO())
    assert line["failed"] == line["attempted"] and not line["correct"]


def test_checks_compare_values_with_limits():
    assert harness.passed({"a": {"value": 0.0, "limit": 0.0}, "b": {"value": 0, "limit": 0}})
    assert not harness.passed({"a": {"value": 1e-7, "limit": 0.0}})
    assert not harness.passed({"a": {"value": float("inf"), "limit": 0.0}})


def test_forbidden_modules_compare_top_level_names_whole():
    names = ["repro_torch.core.api", "torch", "numpy.linalg", "reprox"]
    assert harness.forbidden_modules(names) == []
    assert harness.forbidden_modules(names + ["repro.core"]) == ["repro"]
    assert harness.forbidden_modules(["jaxlib.xla", "flax"]) == ["flax", "jaxlib"]


def test_seed_draws_the_values_and_never_the_graph(small_cell):
    """Every seed runs on the configuration's one graph; the seed draws the
    value batches, the same for the same seed, from any whole number."""
    cell = small_cell(CELLS[1])
    base = harness.make_inputs(cell, 1)
    for seed in (0, 2**31 + 5, 2**40, -3):
        a, b = harness.make_inputs(cell, seed), harness.make_inputs(cell, seed)
        assert (a.traffic.pool == b.traffic.pool).all()
        assert (a.graph.src == base.graph.src).all() and (a.graph.dst == base.graph.dst).all()
    assert not (base.traffic.pool == harness.make_inputs(cell, 2).traffic.pool).all()


def test_frozen_generators_give_the_ports_graphs():
    import numpy as np

    from repro_torch.graphs import generators
    from wbench import graphs

    a = graphs.generator("erdos_renyi")(2000, 10, np.random.default_rng(0))
    b = generators.erdos_renyi(2000, 10, directed=False, seed=0)
    assert (a.src == b.src).all() and (a.dst == b.dst).all() and not a.directed
    a = graphs.generator("random_dag")(2000, 10, np.random.default_rng(5), locality=200)
    b = generators.random_dag(2000, 10, seed=5, locality=200)
    assert (a.src == b.src).all() and (a.dst == b.dst).all() and a.directed

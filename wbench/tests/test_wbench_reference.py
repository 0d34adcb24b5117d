"""The plain reference against a brute-force enumeration of each window,
and against the port on the CPU."""

import numpy as np
import pytest
import torch

from wbench import graphs, reference

ER, DAG = graphs.generator("erdos_renyi"), graphs.generator("random_dag")


def brute_windows(g, kind: str, k: int = 0):
    """Every vertex's window by walking the graph one vertex at a time."""
    nbrs = [set() for _ in range(g.n)]
    for s, d in zip(g.src.tolist(), g.dst.tolist()):
        if kind == "khop":
            nbrs[s].add(d)
            if not g.directed:
                nbrs[d].add(s)
        else:
            nbrs[d].add(s)  # parents
    out = []
    for v in range(g.n):
        seen, frontier = {v}, {v}
        for _ in range(k if kind == "khop" else g.n):
            frontier = set().union(*(nbrs[u] for u in frontier)) - seen
            if not frontier:
                break
            seen |= frontier
        out.append(sorted(seen))
    return out


CASES = [("khop", {"k": 2}, lambda r: ER(300, 6.0, r)),
         ("khop", {"k": 1}, lambda r: ER(200, 4.0, r, directed=True)),
         ("khop", {"k": 3}, lambda r: ER(150, 3.0, r)),
         ("topo", {}, lambda r: DAG(300, 3.0, r)),
         ("topo", {}, lambda r: DAG(400, 10.0, r, locality=30))]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_reference_matches_brute_force(case):
    kind, window, make = CASES[case]
    rng = np.random.default_rng(100 + case)
    g = make(rng)
    vals = rng.integers(0, 100, (3, g.n)).astype(np.float64)
    prepared = reference.module(kind).prepare(g, window, "cpu")
    got = reference.aggregates(kind, prepared, torch.from_numpy(vals), torch.float64)
    for v, w in enumerate(brute_windows(g, kind, window.get("k", 0))):
        x = vals[:, w]
        want = {"sum": x.sum(1), "count": np.full(3, len(w)), "avg": x.sum(1) / len(w),
                "min": x.min(1), "max": x.max(1)}
        for a in reference.AGGREGATES:
            np.testing.assert_array_equal(got[a][:, v].numpy(), want[a], err_msg=f"{a} at {v}")


def test_topo_levels_reject_a_cycle():
    g = graphs.EdgeList(3, np.array([0, 1, 2], np.int32), np.array([1, 2, 0], np.int32), True)
    with pytest.raises(ValueError, match="cycle"):
        reference.module("topo").levels(g)


@pytest.mark.parametrize("name", ["khop2-er45k.batch64", "topo-dag60k.batch64"])
def test_port_on_cpu_matches_reference_exactly(small_cell, name):
    """The port's Session on the CPU (its kernels' plain versions) gives
    the reference's answers rounded to float32, bit for bit."""
    from wbench import harness
    from wbench.system import PortSystem

    cell = small_cell(name)
    inputs = harness.make_inputs(cell, 7)
    vals = inputs.traffic.values(0)
    got = PortSystem(inputs.graph, cell.config, "cpu").run_many(vals)
    kind = cell.config["reference"]
    prepared = reference.module(kind).prepare(inputs.graph, cell.config["window"]["args"], "cpu")
    want = reference.aggregates(kind, prepared, torch.from_numpy(vals), torch.float64)
    for a, g in zip(cell.config["aggregates"], got):
        np.testing.assert_array_equal(g, want[a].to(torch.float32).numpy(), err_msg=a)


def test_control_precision_departs_from_reference():
    """bfloat16 rounds window sums above 256, so the control's answers
    differ from the float64 reference's."""
    rng = np.random.default_rng(5)
    g = DAG(400, 10.0, rng, locality=30)
    vals = torch.from_numpy(rng.integers(0, 100, (2, g.n)).astype(np.float64))
    prepared = reference.module("topo").prepare(g, {}, "cpu")
    exact = reference.aggregates("topo", prepared, vals, torch.float64)
    low = reference.aggregates("topo", prepared, vals, torch.bfloat16)
    assert float((low["sum"].double() - exact["sum"]).abs().max()) > 1

"""What the benchmark loads and refuses: no result without a card, no
JAX and no JAX package in a run, nothing of the program in the reference,
and new cells, configurations, mixes and metrics found by name."""

import ast
import json
import os
import shutil
import subprocess
import sys

from wbench import cells

ROOT = cells.ROOT
SRC = str(ROOT / "src")

SMALL_RUN = """
import dataclasses, json, sys, time
from wbench import cells, harness
c = cells.cell(cells.benchmark(), "khop2-er45k.batch64")
c = dataclasses.replace(c, config={{**cells.config({config!r}), "n": 300, "locality": 30}},
                        mix={{**c.mix, "batch": 4, "pool": 2, "warmup_requests": 1}})
line = harness.run_cell(c, 11, 0.2, {trace}, device="cpu", t_start=time.perf_counter())
print(json.dumps({{"line": line, "modules": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def python(code: str, cwd, *paths: str, env=None) -> subprocess.CompletedProcess:
    env = {**os.environ, **(env or {}), "PYTHONPATH": os.pathsep.join(paths)}
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "wbench/run.py", "--workload", "khop2-er45k.batch64",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_a_run_loads_no_jax_and_no_jax_package():
    for config in ("khop2-er45k", "topo-dag60k"):
        out = python(SMALL_RUN.format(config=config, trace=True), ROOT, str(ROOT), SRC)
        assert out.returncode == 0, out.stderr
        got = json.loads(out.stdout.strip().splitlines()[-1])
        assert got["line"]["correct"]
        assert "repro_torch" in got["modules"]
        assert not {"jax", "jaxlib", "flax", "repro"} & set(got["modules"])


def test_reference_imports_nothing_of_the_program():
    for path in (cells.HERE / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in {"repro_torch", "repro", "jax", "jaxlib",
                                                  "flax"}, (path.name, name)
    code = """
import sys, numpy as np, torch
from wbench import graphs, reference
r = np.random.default_rng(0)
for kind, g, w in (("khop", graphs.generator("erdos_renyi")(100, 4.0, r), {"k": 2}),
                   ("topo", graphs.generator("random_dag")(100, 3.0, r), {})):
    p = reference.module(kind).prepare(g, w, "cpu")
    reference.aggregates(kind, p, torch.ones(2, 100, dtype=torch.float64), torch.float64)
print(sorted({m.split(".")[0] for m in sys.modules}))
"""
    out = python(code, ROOT, str(ROOT))
    assert out.returncode == 0, out.stderr
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not {"repro_torch", "repro", "jax", "jaxlib", "flax"} & loaded


def test_new_cell_config_mix_and_metric_are_found_by_name(tmp_path):
    """A new configuration, mix, per-layer metric and cell are new files and
    new entries: the harness runs the cell with no file that was there
    edited."""
    shutil.copytree(cells.HERE, tmp_path / "wbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in (tmp_path / "wbench").rglob("*") if p.is_file()}
    cfg = json.loads((cells.HERE / "configs" / "khop2-er45k.json").read_text())
    cfg.update(name="khop1-er300", n=300, window={"class": "KHopWindow", "args": {"k": 1}})
    (tmp_path / "wbench/configs/khop1-er300.json").write_text(json.dumps(cfg))
    mix = json.loads((cells.HERE / "mixes" / "batch64.json").read_text())
    mix.update(name="batch3", batch=3, pool=2, warmup_requests=1)
    (tmp_path / "wbench/mixes/batch3.json").write_text(json.dumps(mix))
    (tmp_path / "wbench/metrics/requests_in_window.py").write_text(
        "def read(run):\n    return float(run.window.attempted)\n")
    bench["configs"].append({"name": "khop1-er300", "source": cfg["source"],
                             "file": "wbench/configs/khop1-er300.json", "reduced": ["n"],
                             "why": "a test"})
    bench["workloads"].append({"name": "khop1-er300.batch3", "config": "khop1-er300",
                               "traffic": "batch3", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "requests_in_window", "unit": "requests",
                               "better": "higher", "source": "host_clock", "layer": "harness",
                               "moves": "window_results_per_s",
                               "workloads": ["khop1-er300.batch3"]})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and m["name"] in ("window_results_per_s", "api_host_ms"):
            m["workloads"].append("khop1-er300.batch3")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = """
import json, time
from wbench import cells, harness
c = cells.cell(cells.benchmark(), "khop1-er300.batch3")
line = harness.run_cell(c, 5, 0.2, True, device="cpu", t_start=time.perf_counter())
print(json.dumps(line))
"""
    out = python(code, tmp_path, str(tmp_path), SRC)
    assert out.returncode == 0, out.stderr
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"]
    assert set(line["metrics"]) == {"requests_in_window", "api_host_ms"}
    assert line["metrics"]["requests_in_window"]["value"] == line["attempted"]
    after = {p: p.read_bytes() for p in before}
    assert after == before


#: a generator the benchmark does not have: a ring lattice, relabelled
RING = '''
import numpy as np

from wbench.graphs import EdgeList


def generate(n, avg_degree, rng):
    half = int(avg_degree) // 2
    src = np.repeat(np.arange(n), half)
    dst = (src + np.tile(np.arange(1, half + 1), n)) % n
    perm = rng.permutation(n).astype(np.int32)
    return EdgeList(n, perm[src], perm[dst], False)
'''

#: a loop kind the benchmark does not have: one client, one request every
#: ``interval_s``, alternating between two batches
PACED = '''
import time

from wbench.traffic import Window


class Paced:
    def __init__(self, mix, attribute, n, rng):
        self.interval, self.request, self.sent = mix["interval_s"], mix["request"], 0
        self.pool = rng.integers(attribute["low"], attribute["high"],
                                 (2, mix["batch"], n)).astype(attribute["dtype"])

    def values(self, key):
        return self.pool[key]

    def send(self, system):
        key, self.sent = self.sent % 2, self.sent + 1
        return key, getattr(system, self.request)(self.pool[key])

    def warm_up(self, system, count):
        return [self.send(system) and 0.0 for _ in range(count)]

    def window(self, system, seconds, keep, sample_rng, out=None):
        lat, samples, t_start = [], [], time.perf_counter()
        while time.perf_counter() - t_start < seconds:
            t0 = time.perf_counter()
            key, res = self.send(system)
            lat.append(time.perf_counter() - t0)
            if len(samples) < keep:
                samples.append((len(lat) - 1, key, res))
            time.sleep(max(0.0, self.interval - lat[-1]))
        return Window(lat, time.perf_counter() - t_start, len(lat), 0, samples)

    def profile(self, system, count):
        return [lambda: self.send(system) for _ in range(count)]


def make(cell, graph, rng):
    return Paced(cell.mix, cell.config["attribute"], graph.n, rng)
'''


def test_new_generator_and_loop_kind_are_found_by_name(tmp_path):
    """A graph generator and a traffic loop kind that the benchmark lacks
    are new files, named by a new configuration's ``generator`` and a new
    mix's ``loop``: the harness runs their cell, checks it against the
    reference, and no file that was there is edited."""
    shutil.copytree(cells.HERE, tmp_path / "wbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "wbench").rglob("*") if p.is_file()}
    (tmp_path / "wbench/generators/ring.py").write_text(RING)
    (tmp_path / "wbench/traffic/paced.py").write_text(PACED)
    cfg = json.loads((cells.HERE / "configs" / "khop2-er45k.json").read_text())
    cfg.update(name="khop2-ring300", generator="ring", n=300, avg_degree=4)
    (tmp_path / "wbench/configs/khop2-ring300.json").write_text(json.dumps(cfg))
    mix = {"name": "paced3", "loop": "paced", "clients": 1, "request": "run_many",
           "batch": 3, "interval_s": 0.02, "warmup_requests": 1, "check_requests": 2,
           "profile_requests": 2}
    (tmp_path / "wbench/mixes/paced3.json").write_text(json.dumps(mix))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "khop2-ring300", "source": cfg["source"],
                             "file": "wbench/configs/khop2-ring300.json", "reduced": ["n"],
                             "why": "a test"})
    bench["workloads"].append({"name": "khop2-ring300.paced3", "config": "khop2-ring300",
                               "traffic": "paced3", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("khop2-ring300.paced3")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = """
import json, time
from wbench import cells, harness
c = cells.cell(cells.benchmark(), "khop2-ring300.paced3")
inputs = harness.make_inputs(c, 5)
line = harness.run_cell(c, 5, 0.3, False, device="cpu", t_start=time.perf_counter())
print(json.dumps({"line": line, "edges": int(inputs.graph.src.size),
                  "driver": type(inputs.traffic).__name__}))
"""
    out = python(code, tmp_path, str(tmp_path), SRC)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["edges"] == 600 and got["driver"] == "Paced"
    line = got["line"]
    assert line["correct"], line["checks"]
    assert 1 <= line["attempted"] <= 0.3 / 0.02 + 1
    assert set(line["metrics"]) == {m["name"] for m in bench["end_to_end"]}
    after = {p: p.read_bytes() for p in before}
    assert after == before

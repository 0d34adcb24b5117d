"""BENCHMARK.json against the benchmark's contract, the files it names,
and the arithmetic of the bytes bound and the tail."""

import json
import re

import pytest

from wbench import cells, peaks, stats

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return cells.benchmark()


def line_ok(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert (cells.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert len(bench["command"]) <= 32 and all(line_ok(w) for w in bench["command"])
    for w in bench["command"][1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in bench["paths"])
            assert (cells.ROOT / w).exists()


def test_configs_and_cells(bench):
    assert 1 <= len(bench["configs"]) <= 24 and 1 <= len(bench["workloads"]) <= 24
    used = {w["config"] for w in bench["workloads"]}
    files = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert line_ok(c["source"]) and line_ok(c["why"])
        assert c["file"] == f"wbench/configs/{c['name']}.json" and c["file"] not in files
        files.add(c["file"])
        data = json.loads((cells.ROOT / c["file"]).read_text())
        assert data["source"] == c["source"]
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) and k in data for k in c["reduced"])
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and line_ok(w["why"])
        assert w["chips"] in (1, 4) and (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (cells.HERE / "mixes" / f"{w['traffic']}.json").exists()
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)
    names = [x["name"] for k in ("configs", "workloads") for x in bench[k]]
    assert len(names) == len(set(names))


def test_metrics(bench):
    e2e, layer = bench["end_to_end"], bench["per_layer"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(layer) <= 128
    names = [m["name"] for m in e2e + layer]
    assert len(names) == len(set(names)) and "setup_s" in names
    cell_names = {w["name"] for w in bench["workloads"]}
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in layer:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and line_ok(m["layer"])
        assert m["moves"] in {e["name"] for e in e2e}
    for m in e2e + layer:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cell_names)) <= cell_names
        assert (cells.HERE / "metrics" / f"{m['name']}.py").exists()
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in cell_names:
        c = cells.cell(bench, w)
        assert "setup_s" in [m["name"] for m in c.end_to_end] and len(c.end_to_end) >= 2
        assert c.per_layer
        for m in c.per_layer:
            assert m["moves"] in [e["name"] for e in c.end_to_end]


def test_bytes_bound_arithmetic():
    # [64, 45,000] values read once as float32, five [64, 45,000] results written once
    assert peaks.query_bytes(64, 45_000, 5) == 69_120_000
    ms, what = peaks.bound_ms(69_120_000, 0)
    assert what == "bytes" and ms == pytest.approx(69_120_000 / 3.35e12 * 1e3)
    assert ms == pytest.approx(0.0206328, rel=1e-5)
    ms, what = peaks.bound_ms(1, 67e9)
    assert what == "operations" and ms == pytest.approx(1.0)


def test_percentile_is_nearest_rank_over_raw_samples():
    xs = list(range(1, 201))  # 200 samples: ten lie above the 95th percentile
    assert stats.percentile(xs, 95) == 190
    assert sum(x > stats.percentile(xs, 95) for x in xs) == 10
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([5, 1, 4, 2, 3], 50) == 3
    with pytest.raises(ValueError):
        stats.percentile([], 95)

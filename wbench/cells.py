"""Finding a cell's parts by name.

``BENCHMARK.json`` (at the root of the checkout) lists the cells as
(configuration, traffic mix) pairs and the metrics.  Everything that
belongs to one of them is a file of its own, found by its name:

* ``wbench/configs/<config>.json``: the deployment (graph, window, index,
  the aggregates, the guarantees and the limits of the check);
* ``wbench/mixes/<traffic>.json``: the traffic mix's parameters;
* ``wbench/metrics/<metric>.py``: the metric's reader, a ``read(run)``
  that returns the number or ``None`` when the run holds nothing to read.

A configuration's ``generator`` names its graph's generator
(``wbench/generators/<name>.py``, found by ``graphs.generator``), a mix's
``loop`` its traffic driver (``wbench/traffic/<loop>.py``, found by
``traffic.module``).

So a new configuration, mix, metric or cell is new files and new entries
in ``BENCHMARK.json``, and no edit to a file that is there.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
from typing import List

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    mix: dict
    #: the ``end_to_end`` and ``per_layer`` entries this cell reports
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])


def _json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: pathlib.Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def config(name: str) -> dict:
    return _json(HERE / "configs" / f"{name}.json")


def mix(name: str) -> dict:
    return _json(HERE / "mixes" / f"{name}.json")


def reader(name: str):
    """The module of metric ``name``'s reader."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"wbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(bench: dict, name: str) -> Cell:
    """Cell ``name`` of ``bench`` with its configuration, mix and metrics."""
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                       f"{[w['name'] for w in bench['workloads']]}")
    w = found[0]

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", (name,))]

    return Cell(name, w, config(w["config"]), mix(w["traffic"]),
                mine(bench["end_to_end"]), mine(bench["per_layer"]))

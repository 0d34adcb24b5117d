"""The benchmark's cells on the card at a small size: a traced run reads
every per-layer metric and comes out correct; the control does not.  They
skip without a card; run them there with
``PYTHONPATH=src python -m pytest -q -m cuda wbench/tests``."""

import time

import pytest
import torch

from wbench import harness
from wbench.system import ReferenceSystem

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("name", ["khop2-er45k.batch64", "topo-dag60k.batch64"])
def test_traced_run_on_the_card(cuda, small_cell, name):
    cell = small_cell(name)
    line = harness.run_cell(cell, 3, 0.5, True, device=cuda, t_start=time.perf_counter())
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {m["name"] for m in cell.per_layer}
    assert 0 < line["metrics"]["query_kernels_roofline"]["value"] <= 100
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    assert line["breakdown"]["device_ops"]
    line = harness.run_cell(cell, 3, 0.5, False, device=cuda, t_start=time.perf_counter(),
                            system_class=ReferenceSystem)
    assert not line["correct"]

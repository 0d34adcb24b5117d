"""The device trace's arithmetic and the metric readers, on a synthetic
trace and run (the profiler itself needs the card)."""

import types

import pytest

from wbench import cells, peaks
from wbench.devprof import REQUEST, STRETCH, DeviceTrace
from wbench.harness import Run, Window

# two requests over 0..100 us: copies, K1 and its fixup, the scan, one
# kernel overlapping another on a second stream
DEVICE = [("Memcpy HtoD (Pageable -> Device)", 0, 10),
          ("void at::native::vectorized_gather_kernel<16, long>(char*)", 82, 84),
          ("void at::native::reduce_kernel<128, 4>(ReduceOp<float>)", 84, 85),
          ("void segment_reduce_kernel_wide<true, -1>(Wide)", 10, 20),
          ("void segment_reduce_wide_fixup<true, -1>(Wide)", 20, 22),
          ("void inherit_scan_kernel<32, true>(float const*)", 15, 25),
          ("Memcpy DtoH (Device -> Pageable)", 40, 60),
          ("Memcpy DtoH (Device -> Pageable)", 70, 80)]
HOST = [(STRETCH, 0, 100), (REQUEST, 0, 50), (REQUEST, 50, 100),
        ("aten::copy_", 25, 40), ("aten::copy_", 60, 64)]


def trace():
    return DeviceTrace(2, 0.0, 100.0, list(DEVICE), list(HOST))


def test_busy_time_is_the_union_of_device_events():
    d = trace()
    assert d.busy_s() == pytest.approx(58e-6)  # 0..25, 40..60, 70..80, 82..85
    assert d.gaps() == [(25, 40), (60, 70), (80, 82), (85, 100)]
    assert d.device_s("Memcpy DtoH") == pytest.approx(30e-6)
    assert d.device_s() == pytest.approx(65e-6)


def test_idle_gaps_are_named_by_the_innermost_host_operation():
    d = trace()
    assert d.host_at(30) == "aten::copy_"
    assert d.host_at(67) == REQUEST
    assert d.host_at(150) == "host"
    b = d.breakdown()
    assert b["idle_gaps"][0] == [REQUEST, pytest.approx(27e-6)]  # 60..70, 80..82, 85..100
    assert b["idle_gaps"][1] == ["aten::copy_", pytest.approx(15e-6)]
    assert b["device_ops"][0] == ["Memcpy DtoH (Device -> Pageable)", pytest.approx(30e-6)]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def run(spans=None, device=None):
    cell = cells.cell(cells.benchmark(), "khop2-er45k.batch64")
    win = Window([0.02, 0.03, 0.05, 0.02], 0.12, 4, 0, [])
    return Run(cell, 64, 45_000, 30.0, {"inputs_s": 1.0, "build_s": 25.0, "warmup_s": 3.0},
               win, spans, device)


def read(name, r):
    return cells.reader(name).read(r)


def test_end_to_end_readers():
    r = run()
    assert read("window_results_per_s", r) == pytest.approx(64 * 45_000 * 4 / 0.12)
    assert read("batch_p95_ms", r) == pytest.approx(50.0)
    assert read("setup_s", r) == 30.0
    assert read("index_build_s", r) == 25.0


def test_span_readers():
    spans = [{"ph": "X", "name": "query.term", "dur": 15_000.0},
             {"ph": "X", "name": "query.term", "dur": 25_000.0},
             {"ph": "X", "name": "query.group", "dur": 99_000.0}]
    r = run(spans=spans)
    assert read("query_term_ms", r) == pytest.approx(40.0 / 4)
    assert read("api_host_ms", r) == pytest.approx((120.0 - 40.0) / 4)
    assert read("query_term_ms", run()) is None


def test_device_readers():
    r = run(device=trace())
    assert read("copy_ms", r) == pytest.approx(40e-3 / 2)
    assert read("k1_ms", r) == pytest.approx(12e-3 / 2)
    assert read("scan_ms", r) == pytest.approx(10e-3 / 2)
    assert read("ell_minmax_ms", r) == pytest.approx(3e-3 / 2)
    assert read("device_idle_pct", r) == pytest.approx(42.0)
    least_ms, _ = peaks.bound_ms(peaks.query_bytes(64, 45_000, 5), 0)
    assert read("query_kernels_roofline", r) == pytest.approx(100 * least_ms / (25e-3 / 2))
    for name in ("copy_ms", "k1_ms", "scan_ms", "ell_minmax_ms", "device_idle_pct",
                 "query_kernels_roofline"):
        assert read(name, run()) is None


def test_a_reader_with_nothing_to_read_gives_none_not_zero():
    bare = DeviceTrace(1, 0.0, 10.0, [("Memcpy HtoD (Pageable -> Device)", 0, 5)], [])
    r = run(device=bare)
    assert read("k1_ms", r) is None and read("scan_ms", r) is None
    assert read("ell_minmax_ms", r) is None
    assert read("query_kernels_roofline", r) is None


def test_every_metric_has_a_reader():
    bench = cells.benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert isinstance(cells.reader(m["name"]).read, types.FunctionType)

"""The query's kernels' share of their roofline, in per cent: the least
time of a request's bytes (``peaks.query_bytes``: the values read once and
the results written once, at the card's memory rate) over the device time
of everything the request ran on the card but its copies, from the
profiled stretch."""

from wbench.devprof import COPY_NAMES
from wbench.peaks import bound_ms, query_bytes


def read(run):
    d = run.device
    if d is None:
        return None
    kernels_ms = (d.device_s() - d.device_s(*COPY_NAMES)) / d.requests * 1e3
    if kernels_ms <= 0:
        return None
    least_ms, _ = bound_ms(query_bytes(run.batch, run.n, len(run.cell.config["aggregates"])), 0)
    return 100 * least_ms / kernels_ms

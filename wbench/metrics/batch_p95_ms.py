"""The 95th percentile of every request's latency in the window, from the
call to the results on the host, in milliseconds.  Host clock, raw
latencies (nearest rank)."""

from wbench.stats import percentile


def read(run):
    return percentile(run.window.latencies_s, 95) * 1e3

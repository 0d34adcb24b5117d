"""Milliseconds a request in the Session API around the executors: the
mean per request of the request's latency less its ``query.term`` spans
(the port's tracer), over the traced window."""


def read(run):
    if not run.spans:
        return None
    term_s = sum(e["dur"] for e in run.spans
                 if e["ph"] == "X" and e["name"] == "query.term") / 1e6
    return (sum(run.window.latencies_s) - term_s) / run.window.attempted * 1e3

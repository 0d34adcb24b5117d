"""Milliseconds a request inside the port's query executors: the mean per
request of the ``query.term`` spans the port's tracer records over the
traced window (each ends after the results' copy to the host)."""


def read(run):
    if not run.spans:
        return None
    term_s = sum(e["dur"] for e in run.spans
                 if e["ph"] == "X" and e["name"] == "query.term") / 1e6
    return term_s / run.window.attempted * 1e3

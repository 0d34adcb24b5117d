"""Window results a second: one result is one vertex's aggregates for one
attribute vector, so ``B x n`` per completed request, over all of the
window's seconds.  Host clock."""


def read(run):
    w = run.window
    return run.batch * run.n * (w.attempted - w.failed) / w.window_s

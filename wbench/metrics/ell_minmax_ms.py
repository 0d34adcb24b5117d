"""Device milliseconds a request in the ELL min/max route
(``engine_torch._ell_reduce``): the dense gather of each padded row of a
plan's ELL layout and the axis min and max over it, from the profiled
stretch.  The trace names them only by PyTorch's kernels (its
``at::native`` gather and reduce kernels); nothing else in a batched
query's request launches either, and a plan without ELL layouts launches
neither."""

KERNELS = ("gather_kernel", "at::native::reduce_kernel<")


def read(run):
    d = run.device
    if d is None:
        return None
    s = sum(e - b for name, b, e in d.device
            if "at::native::" in name and any(k in name for k in KERNELS))
    return s / 1e3 / d.requests or None

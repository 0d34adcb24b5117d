"""Device milliseconds a request in K1 (``segment_reduce_kernel``, the
wide route's ``segment_reduce_kernel_wide`` and its
``segment_reduce_wide_fixup``), from the profiled stretch."""


def read(run):
    if run.device is None:
        return None
    ms = run.device.device_s("segment_reduce") / run.device.requests * 1e3
    return ms or None

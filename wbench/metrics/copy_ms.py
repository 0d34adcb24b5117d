"""Device milliseconds a request in copies between host and device (values
up, results back), from the profiled stretch of the traced run."""

from wbench.devprof import COPY_NAMES


def read(run):
    if run.device is None:
        return None
    return run.device.device_s(*COPY_NAMES) / run.device.requests * 1e3

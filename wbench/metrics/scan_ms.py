"""Device milliseconds a request in the inheritance scan
(``inherit_scan_kernel``), from the profiled stretch."""


def read(run):
    if run.device is None:
        return None
    ms = run.device.device_s("inherit_scan") / run.device.requests * 1e3
    return ms or None

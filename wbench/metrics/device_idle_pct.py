"""The card's idle share, in per cent: the part of the profiled stretch's
wall time in which no kernel and no copy ran on the card."""


def read(run):
    d = run.device
    if d is None:
        return None
    return 100 * (1 - d.busy_s() / ((d.t1_us - d.t0_us) / 1e6))

"""Seconds of the port's ``Session`` build in set-up: the host index (EMC's
DBIndex or the I-Index) and the device plan.  Host clock."""


def read(run):
    return run.phases["build_s"]

"""Set-up seconds: from the process's start to the first timed request
(imports, the kernel libraries' load or build, the inputs, the index and
plan build, the warm-up).  Host clock."""


def read(run):
    return run.setup_s

"""Set-up: process start to the first timed request, on the host clock."""


def read(run):
    return run.setup_s

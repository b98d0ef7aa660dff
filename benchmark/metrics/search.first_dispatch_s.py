"""The first search step's host time: the graph's warm-up step, its
capture, and its first replay."""


def read(run):
    return run.record["first_dispatch_s"]

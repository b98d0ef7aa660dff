"""Wall time of the graph's capture: the step's Python and the
graph's instantiation."""

from benchmark.lib.spans import counter


def read(run):
    return counter(run, "capture_s")

"""Host time of the graph's warm-up step before its capture, up to its
synchronize."""

from benchmark.lib.spans import counter


def read(run):
    return counter(run, "warmup_s")

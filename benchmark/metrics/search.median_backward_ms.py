"""Device time of median's backward in the search step's last replay that
no profiler recorded: the spans median.backward (the backward op's body, its
recompute of the plain form included), captured in the graph as timing
events, summed."""

from benchmark.lib.spans import graph_ms


def read(run):
    return graph_ms(run, "median.backward")

"""Device time of the search step in the graph's last replay that no
profiler recorded: the span darts.step, captured in the graph as a pair of
timing events."""

from benchmark.lib.spans import graph_ms


def read(run):
    return graph_ms(run, "darts.step")

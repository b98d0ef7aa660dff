"""Host time of a graph replay: the host seconds inside graph.replay()
over the replays made while no profiler recorded, after the first (which
uploads the graph, in set-up), in ms."""

from benchmark.lib.spans import counter


def read(run):
    replays = counter(run, "replays")
    if not replays:
        return None
    return 1e3 * counter(run, "replay_host_s") / replays

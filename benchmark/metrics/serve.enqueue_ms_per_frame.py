"""Host time of the serving call per profiled frame: the span serve.frame,
from the call to its return, before the benchmark's synchronize."""

from benchmark.lib.spans import ms_per_frame


def read(run):
    return ms_per_frame(run, lambda n: n == "serve.frame", device=False)

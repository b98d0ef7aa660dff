"""Device time of the demosaic step per profiled frame: the spans
pipeline.demosaic.*, each between timing events on the device."""

from benchmark.lib.spans import ms_per_frame


def read(run):
    return ms_per_frame(run, lambda n: n.startswith("pipeline.demosaic."))

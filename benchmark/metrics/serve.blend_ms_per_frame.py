"""Device time of the tile blend per profiled frame: the spans serve.blend
(each tile group's feathered accumulate and the frame's divide), each
between timing events on the device."""

from benchmark.lib.spans import ms_per_frame


def read(run):
    return ms_per_frame(run, lambda n: n == "serve.blend")

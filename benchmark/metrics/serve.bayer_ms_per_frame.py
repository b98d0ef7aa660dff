"""Device time of the Bayer-domain pipeline steps per profiled frame: the
spans pipeline.bayer.* (the RGGB pack and Path-Restore, their layout
passes included), each between timing events on the device."""

from benchmark.lib.spans import ms_per_frame


def read(run):
    return ms_per_frame(run, lambda n: n.startswith("pipeline.bayer."))

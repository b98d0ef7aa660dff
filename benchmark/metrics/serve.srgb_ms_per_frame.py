"""Device time of the sRGB-domain steps per profiled frame (gamma, CCM,
white balance): the spans pipeline.srgb.*, each between timing events on
the device."""

from benchmark.lib.spans import ms_per_frame


def read(run):
    return ms_per_frame(run, lambda n: n.startswith("pipeline.srgb."))

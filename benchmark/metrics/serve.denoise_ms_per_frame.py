"""Device time of the windowed denoising steps per profiled frame: the
spans pipeline.srgb.median and pipeline.srgb.fastnlm, one per tile group,
each between timing events on the device."""

from benchmark.lib.spans import ms_per_frame

SPANS = ("pipeline.srgb.median", "pipeline.srgb.fastnlm")


def read(run):
    return ms_per_frame(run, lambda n: n in SPANS)

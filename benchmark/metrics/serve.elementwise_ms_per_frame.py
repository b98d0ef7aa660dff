"""Device time of every kernel group but convolution and layout per profiled
frame: demosaic, colour and tone, the tile blend, copies."""

OTHER_THAN = ("convolution", "layout")


def read(run):
    if run.trace is None:
        return None
    frames = sum(run.record["profiled"])
    return 1e3 * sum(s for g, s in run.trace.by_group().items()
                     if g not in OTHER_THAN) / frames

"""Device time of the convolution and layout kernel groups per profiled
frame (the CNN on cuDNN)."""

GROUPS = ("convolution", "layout")


def read(run):
    if run.trace is None:
        return None
    frames = sum(run.record["profiled"])
    got = run.trace.by_group()
    return 1e3 * sum(got.get(g, 0.0) for g in GROUPS) / frames

"""Megapixels of every frame served in the window over the window's time."""


def read(run):
    r = run.record
    return r["frames"] * r["mp_per_frame"] / r["window_s"]

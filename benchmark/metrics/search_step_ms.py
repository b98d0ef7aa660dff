"""The window's time over the search steps completed in it."""


def read(run):
    r = run.record
    return 1e3 * r["window_s"] / r["steps"]

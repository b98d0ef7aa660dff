"""95th percentile of every frame's time in the window (nearest rank), each
from the call to its output after a synchronize."""

import math


def read(run):
    times = sorted(run.record["frame_s"])
    return 1e3 * times[math.ceil(0.95 * len(times)) - 1]

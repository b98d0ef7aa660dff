"""The fast-NLM kernel's share of its roofline over the profiled frames: the
least time of one application to each 512 x 512 x 3 tile of a frame at the
radii the program runs (benchmark/lib/counts.kernel_bound_s; the system's
work()["windowed"]), times the profiled frames, over the device time of the
kernel's launches.  Nothing when the stretch launched none."""

from benchmark.lib.roofline import share


def read(run):
    return share(run, "fastnlm")

"""The bilateral kernel's share of its roofline in the profiled stretch: the least
time of the forward applications of bilateral that the profiled steps need
(benchmark/lib/counts.kernel_bound_s, from each application's input shape
and its slot's radii at the profiled step) over the device time of the
kernel's launches.  Nothing when the stretch launched none."""

from benchmark.lib.roofline import share


def read(run):
    return share(run, "bilateral")

"""Share of the profiled stretch in which no kernel ran on the device, the
stretch less the stalls the profiler's own records cover
(benchmark/lib/trace.py: INSTRUMENT)."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * run.trace.idle_share()

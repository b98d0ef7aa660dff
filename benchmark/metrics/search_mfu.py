"""A search step's counted operations (benchmark/lib/counts.py) over the
time of the window's steps that were not profiled, as a share of the chip's
float32 peak."""


def read(run):
    r = run.record
    times = [t for t, p in zip(r["step_s"], r["profiled"]) if not p]
    if not times:
        return None
    w = run.work
    return 100.0 * w["flops_per_step"] * len(times) / sum(times) \
        / w["peak_flops"]

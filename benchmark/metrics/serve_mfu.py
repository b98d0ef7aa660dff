"""A served frame's counted operations (benchmark/lib/counts.py) over the
time of the window's frames that were not profiled, as a share of the
chip's peak in the precision of the convolutions."""


def read(run):
    r = run.record
    times = [t for t, p in zip(r["frame_s"], r["profiled"]) if not p]
    if not times:
        return None
    w = run.work
    return 100.0 * w["flops_per_frame"] * len(times) / sum(times) \
        / w["peak_flops"]

"""A hand kernel's share of its roofline over a profiled stretch."""

from __future__ import annotations

from benchmark.lib import counts


def share(run, op: str):
    """100 x the least time of the op's forward applications that the
    profiled steps need (the system's work()["windowed"], each from its
    input shape and radii) over the device time of the op's kernels in the
    stretch; None without launches or applications.  The least time is
    counted from the work, not from the launches, so grouping applications
    into fewer, larger launches leaves it as it is."""
    if run.trace is None:
        return None
    launches = run.trace.named(f"{op}_kernel")
    need = run.work.get("windowed", {}).get(op)
    if not launches or not need:
        return None
    steps = sum(run.record["profiled"])
    bound = steps * sum(counts.kernel_bound_s(op, shape, r, block)
                        for shape, r, block in need)
    return 100.0 * bound / sum(s for _, s in launches)

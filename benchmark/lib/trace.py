"""A profiled stretch of a run, reduced in memory.

torch.profiler records the host's operations and the device's kernels over
the stretch; nothing is written to disk.  The reduction keeps each kernel's
name and interval, the stretch's span (the `bench.stretch` range around it),
and the host ranges, to name what the host was doing while the device
idled.  Busy time is the union of the kernels' intervals, so kernels that
overlap count once.
"""

from __future__ import annotations

import torch
from torch.profiler import ProfilerActivity, profile, record_function

STRETCH = "bench.stretch"
# the profiler's own records of time it took: CUPTI flushing its activity
# buffers stalls the device (a captured search step fills them many times)
INSTRUMENT = ("Buffer Flush", "Activity Buffer Request")

# kernel-name fragments -> group, first match wins (the grouping of the
# port's profiling tools, frozen here)
GROUPS = (("bilateral", "bilateral kernel"), ("median", "median kernel"),
          ("fastnlm", "fastnlm kernel"),
          ("nchwtonhwc", "layout"), ("nhwctonchw", "layout"),
          ("transpose", "layout"),
          ("conv", "convolution"), ("xmma", "convolution"),
          ("gemm", "convolution"), ("cudnn", "convolution"),
          ("copy", "copy"), ("memcpy", "copy"), ("memset", "copy"),
          ("reduce", "reduction"))


def group(name: str) -> str:
    low = name.lower()
    for frag, grp in GROUPS:
        if frag in low:
            return grp
    return "elementwise"


class Trace:
    """kernels: [(name, start_us, end_us)] sorted by start; host: [(name,
    start_us, end_us)]; span: (start_us, end_us) of the stretch."""

    def __init__(self, kernels, host, span):
        self.kernels = sorted(kernels, key=lambda k: k[1])
        self.host = host
        self.span = span

    @property
    def window_s(self) -> float:
        return (self.span[1] - self.span[0]) / 1e6

    def busy(self) -> list:
        """The union of kernel intervals inside the span, as intervals."""
        lo, hi = self.span
        out = []
        for _, s, e in self.kernels:
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) / 1e6

    def by_group(self) -> dict:
        """{group: seconds of kernel time}."""
        out: dict = {}
        for name, s, e in self.kernels:
            out[group(name)] = out.get(group(name), 0.0) + (e - s) / 1e6
        return out

    def named(self, fragment: str) -> list:
        """[(name, seconds)] of the kernels whose name holds `fragment`."""
        return [(n, (e - s) / 1e6) for n, s, e in self.kernels
                if fragment in n]

    def gaps(self) -> list:
        """[(start_us, end_us)] where no kernel ran, inside the span."""
        lo, hi = self.span
        out, at = [], lo
        for s, e in self.busy():
            if s > at:
                out.append((at, s))
            at = max(at, e)
        if hi > at:
            out.append((at, hi))
        return out

    def instrument_idle_s(self) -> float:
        """Seconds of the gaps that the profiler's own records (INSTRUMENT)
        cover: idle time the measurement made."""
        marks = sorted((s, e) for n, s, e in self.host if n in INSTRUMENT)
        total = 0.0
        for gs, ge in self.gaps():
            reach = gs
            for s, e in marks:
                s, e = max(s, reach), min(e, ge)
                if e > s:
                    total += e - s
                    reach = e
        return total / 1e6

    def idle_share(self) -> float:
        """Idle over the stretch, both less what the profiler's own
        records cover."""
        inst = self.instrument_idle_s()
        return (self.window_s - self.busy_s - inst) / (self.window_s - inst)

    def host_at(self, t: float) -> str:
        """The innermost host range open at t, or 'no host op'."""
        best = None
        for name, s, e in self.host:
            if s <= t <= e and name != STRETCH and (
                    best is None or e - s < best[1] - best[0]):
                best = (s, e, name)
        return best[2] if best else "no host op"

    def breakdown(self, top: int = 10) -> dict:
        groups = sorted(self.by_group().items(), key=lambda t: -t[1])[:top]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[g, s] for g, s in groups],
                "idle_gaps": [[self.host_at((s + e) / 2), (e - s) / 1e6]
                              for s, e in gaps]}


def capture(fn, device) -> Trace:
    """fn() under the profiler, ending in a synchronize; -> its Trace."""
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(STRETCH):
            fn()
            torch.cuda.synchronize(device)
    kernels, host, span = [], [], None
    for e in prof.events():
        item = (e.name, e.time_range.start, e.time_range.end)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation:
                kernels.append(item)
        elif e.name == STRETCH:
            span = (e.time_range.start, e.time_range.end)
        else:
            host.append(item)
    if span is None or not kernels:
        raise RuntimeError("the profiler recorded no device time over the "
                           "stretch")
    return Trace(kernels, host, span)

"""The program's own spans and graph counters, for the per-layer readers.

The port records spans at its layer boundaries while a profiler records
(reconfigisp_tpu_torch/utils/tracing.py), so a --trace 1 run's profiled
stretch leaves them in the program's store; a search step captured as a
CUDA graph carries its device spans as timing events, and the graph's
runner (search/darts._StepGraph, DartsTrainer.graph) keeps its counters.
A program without them gives nothing here, and the readers return None.
"""

from __future__ import annotations


def recorded():
    """[Span] the program recorded, or None where it records none."""
    try:
        from reconfigisp_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.spans() or None


def ms_per_frame(run, match, device: bool = True):
    """Σ device (or host) time of the spans whose name `match` accepts,
    in ms per profiled frame; None without such spans."""
    spans = recorded()
    if run.trace is None or spans is None:
        return None
    times = [s.device_s if device else s.host_s for s in spans
             if match(s.name)]
    if not times or None in times:
        return None
    return 1e3 * sum(times) / sum(run.record["profiled"])


def graph(run):
    """The search step's graph runner, None without one."""
    trainer = getattr(run.system, "trainer", None)
    return None if trainer is None else trainer.graph


def graph_ms(run, name: str):
    """Σ ms of the graph's captured spans called `name` in its last
    replay; None where the graph has none."""
    read = getattr(graph(run), "device_spans", None)
    if read is None:
        return None
    times = [ms for n, _, ms in read() if n == name]
    return sum(times) if times else None


def counter(run, name: str):
    """The graph runner's counter `name`, None where it has none."""
    return getattr(graph(run), name, None)

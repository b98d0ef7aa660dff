"""Spans at the port's layer boundaries, on the profiler's clock.

`span(name, device=False)` marks a region of the program.  Spans are on
while a torch.profiler is recording, or within `enable()`, and never while
torch.compile or torch.export traces the code.  Off, `span` returns one
shared no-op context and records nothing; it never enters
`record_function`, which costs microseconds even with the profiler off.
On, a span is

  * a `torch.profiler.record_function` range, so a profiler's trace (the
    benchmark's, or `train.trace_steps`' Chrome trace) shows it on the host
    timeline beside the kernels;
  * a record in an in-memory store: (name, parent, request, host_s,
    device_s).  `parent` is the index in the store of the innermost span
    open when it began (None for a root), `request` the number of its root
    span (a served frame, a dispatched step), `host_s` its host time and,
    with `device=True`, `device_s` the device time between a pair of timing
    CUDA events on the current stream, read in `spans()` after a
    synchronize (None otherwise).

A CUDA graph replays without Python, so no span opens inside a replay.
Within `graph_spans()` a `device=True` span opened while the current stream
captures a graph records a pair of external timing events into the graph,
whether spans are on or off: they time the span on every replay.  The block
yields the list of those spans, [name, parent, start event, end event], the
parent an index into that list; the graph's runner keeps it and reads the
events after a replay (search/darts._StepGraph.device_spans).

The names the port opens (README, "Tracing"):

  serve.frame                   a served frame (deploy.make_serving_fn), root
  serve.chunk                   a group of tiles (parallel/tiling.py)
  pipeline.<domain>.<op>        a pipeline step, device (pipeline.py)
  serve.blend                   the feathered accumulate, the divide, device
  darts.step                    a DARTS step, root, device (search/darts.py)
  darts.virtual, darts.unrolled, darts.hessian_pos, darts.hessian_neg,
  darts.alpha, darts.update     its passes, device
  <op>.backward                 a windowed op's backward, device
                                (ops/kernels/_vjp.py)
  search.replay                 the host's replay of the step's graph

Spans open and close on one thread at a time: the autograd engine's
device thread runs a backward while the thread that called it waits, so a
backward span nests under the pass that called `autograd.grad`.
"""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple, Optional

import torch

_NULL = contextlib.nullcontext()   # what span() returns while off
_enabled = 0                       # open enable() blocks
_store: list = []                  # [name, parent, request, host_s, device_s]
_open: list = []                   # store indices of the open spans
_pending: list = []                # (store index, start event, end event)
_requests = 0                      # root spans so far
_graph: Optional[list] = None      # spans of the open graph_spans() block
_graph_open: list = []             # its indices of the open captured spans


class Span(NamedTuple):
    name: str
    parent: Optional[int]
    request: int
    host_s: Optional[float]
    device_s: Optional[float]


def profiling() -> bool:
    """Whether a torch.profiler is recording on this thread."""
    return torch._C._autograd._profiler_enabled()


def span(name: str, device: bool = False):
    """A context manager that marks the region as `name` (module
    docstring).  `device`: time the region on the device too, with timing
    CUDA events on the current stream; the caller passes whether its
    tensors are on CUDA."""
    if device and _graph is not None and torch.cuda.is_initialized() \
            and torch.cuda.is_current_stream_capturing():
        return _CapturedSpan(name)
    if not (_enabled or profiling()) or torch.compiler.is_compiling():
        return _NULL
    return _Span(name, device)


class _Span:
    __slots__ = ("name", "device", "index", "range", "events", "t0")

    def __init__(self, name: str, device: bool):
        self.name, self.device = name, device

    def __enter__(self):
        global _requests
        parent = _open[-1] if _open else None
        if parent is None:
            request, _requests = _requests, _requests + 1
        else:
            request = _store[parent][2]
        self.index = len(_store)
        _store.append([self.name, parent, request, None, None])
        _open.append(self.index)
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        self.events = None
        if self.device:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record()
            _pending.append((self.index,) + self.events)
        _store[self.index][3] = time.perf_counter() - self.t0
        self.range.__exit__(*exc)
        _open.pop()
        return False


class _CapturedSpan:
    __slots__ = ("name", "index")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        start = torch.cuda.Event(enable_timing=True, external=True)
        end = torch.cuda.Event(enable_timing=True, external=True)
        start.record()
        self.index = len(_graph)
        _graph.append([self.name, _graph_open[-1] if _graph_open else None,
                       start, end])
        _graph_open.append(self.index)
        return self

    def __exit__(self, *exc):
        _graph[self.index][3].record()
        _graph_open.pop()
        return False


@contextlib.contextmanager
def enable():
    """Spans on within the block, with no profiler: for tests, and to
    cost the spans apart from the profiler."""
    global _enabled
    _enabled += 1
    try:
        yield
    finally:
        _enabled -= 1


@contextlib.contextmanager
def graph_spans():
    """Collect the device spans of a CUDA graph capture made within the
    block: yields their list (module docstring)."""
    global _graph
    _graph = []
    _graph_open.clear()
    try:
        yield _graph
    finally:
        _graph = None


def spans() -> list:
    """[Span] recorded since the last reset(), in the order they opened;
    device times are read here, after waiting for their events."""
    for index, start, end in _pending:
        end.synchronize()
        _store[index][4] = start.elapsed_time(end) / 1e3
    _pending.clear()
    return [Span(*record) for record in _store]


def reset() -> None:
    """Forget the recorded spans; none may be open."""
    global _requests
    if _open:
        raise RuntimeError(f"reset() inside the open span "
                           f"{_store[_open[-1]][0]!r}")
    _store.clear()
    _pending.clear()
    _requests = 0

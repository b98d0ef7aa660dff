"""The hand-written kernels as torch.library custom ops, and their autograd.

Counterpart of reconfigisp_tpu/ops/denoise.py:_make_hybrid and _strip_vjp.
`windowed_op` defines two ops per kernel: `reconfigisp::<name>(x, params)`
and `reconfigisp::<name>_backward(x, params, g, need_x, need_p)`.  The
forward's CUDA implementation launches the Hopper kernel (_build.launch) and
counts the launch; its CPU implementation is the plain PyTorch form; its fake
implementation, which torch.export and torch.compile trace through, makes
the kernel's operand checks and returns an empty contiguous output.  So an
exported program holds each kernel as one opaque call, and runs the kernel
on the card and the plain form on the CPU.

The JAX package has no backward kernel: its custom_vjp differentiates the
jnp form.  Here the forward op's autograd keeps x and params, and its
backward is the backward op.  Its CUDA implementation launches the
kernel's backward kernel (csrc/<name>.cu, <name>_backward) and counts its
launches under `<name>.backward`, so the card runs no plain backward.  Its
CPU implementation recomputes the plain form from x and params under
autograd and returns that form's gradient: directly for a frame of at most
DIRECT_ROWS rows, and above that strip by strip (`strip_vjp`), which
bounds the plain form's tap residuals at STRIP + 2 halo rows.  On the same
saved inputs the direct gradient is the plain form's own, bit for bit: the
plain forms pad by slices and flips (ops/nn.reflect), so their backward
adds in a fixed order.  The backward op has no autograd of its own: the
kernels are differentiable once, as the DARTS step needs (it
differentiates each kernel once).  `vjp` and `strip_vjp` are plain
functions of the plain form, so the CPU tests reach the code the backward
runs.

A CUDA graph (search/darts.make_darts_multi_step) captures the backward op
with the rest of a search step.  A sync is an error inside a capture, so
each plain form has a capture-safe route that reads no tensor on the host:
it keeps its window bounds on the device (`bounds_static`), and on the same
inputs it gives the host-read route's value and gradients bit for bit.  A
replay runs no Python, so no wrapper counts what it launches: the graph
runner tallies the launches its capture made (`tally_launches`) and adds
them to the kernels' counts on each replay (`count_launches`).

The backward op's body is the span `<name>.backward` (utils/tracing.py), on
the device for a CUDA input: in a captured step it times each windowed op's
backward kernel on every replay.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

from reconfigisp_tpu_torch.ops.kernels import _build
from reconfigisp_tpu_torch.utils import tracing

DIRECT_ROWS = 640  # direct backward up to this many rows (_VJP_DIRECT_ROWS)
STRIP = 256        # output rows a chunk of the strip backward owns

Plain = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

_static_depth = 0   # open static_bounds() blocks
_on_launch: dict[str, Callable[[int], None]] = {}   # kernel name -> its count
_tally: Optional[dict] = None   # launches of the open tally_launches() block


@contextlib.contextmanager
def static_bounds():
    """Every plain form takes its capture-safe route within the block, on
    every thread (the autograd engine runs a CUDA backward on its own): the
    graph runner's warm-up and capture, and the CPU tests of the route."""
    global _static_depth
    _static_depth += 1
    try:
        yield
    finally:
        _static_depth -= 1


def bounds_static(x: torch.Tensor, static: Optional[bool] = None) -> bool:
    """Whether a plain form on x keeps its window bounds on the device, as a
    capture needs: `static` where the caller says, else within
    static_bounds() or while x's current stream captures a CUDA graph."""
    if static is not None:
        return static
    return _static_depth > 0 or (
        x.is_cuda and torch.cuda.is_current_stream_capturing())


@contextlib.contextmanager
def tally_launches():
    """Within the block the kernels' launches are tallied in the yielded
    {name: launches} instead of their modules' counts: a graph's capture,
    whose launches happen on each replay, and the warm-up before it, which
    is no step of the run."""
    global _tally
    outer, _tally = _tally, {name: 0 for name in _on_launch}
    try:
        yield _tally
    finally:
        _tally = outer


def count_launches(tally: dict) -> None:
    """Add a replay's launches, as its capture tallied them, to the
    kernels' counts: one call a kernel."""
    for name, n in tally.items():
        if n:
            _on_launch[name](n)


def _launched(name: str, n: int = 1) -> None:
    if _tally is not None:
        _tally[name] += n
    else:
        _on_launch[name](n)


def _grads(plain: Plain, x, params, g, needs):
    """(gx, gp) of sum(plain(x, params) * g) for the inputs `needs` marks;
    None for the others and for an input the output does not depend on (the
    median's params, which set only its radius)."""
    with torch.enable_grad():
        xs = x.detach().requires_grad_(needs[0])
        ps = params.detach().requires_grad_(needs[1])
        out = plain(xs, ps)
        wrt = [t for t, need in zip((xs, ps), needs) if need]
        got = (torch.autograd.grad(out, wrt, g, allow_unused=True)
               if out.requires_grad else [None] * len(wrt))
    it = iter(got)
    return tuple(next(it) if need else None for need in needs)


def strip_vjp(plain: Plain, halo: int, x, params, g, needs=(True, True),
              strip: int = STRIP):
    """The gradient of a windowed op computed chunk by chunk of rows.

    Output row j depends only on input rows within `halo` of j.  Chunk s owns
    output rows [s strip, (s+1) strip) and runs the plain form on the slab of
    L = strip + 2 halo real frame rows from clip(s strip - halo, 0, H - L).
    Its owned rows then see the values (and Jacobian) of the whole frame: an
    interior slab gives each a full halo of real rows, and a slab at the
    frame's edge starts or ends at it, so the op's own reflection (fast-NLM's
    of the difference field too) falls on the rows it falls on in the whole
    frame.  The cotangent is cut to the owned rows, so rows that slabs share
    are counted once; the slabs' gradients are added into gx and gp."""
    n, h, w, c = x.shape
    strip = min(strip, h)
    length = strip + 2 * halo
    if h <= length:
        return _grads(plain, x, params, g, needs)
    gx = torch.zeros_like(x) if needs[0] else None
    gp = None
    for s in range(-(-h // strip)):
        start = min(max(s * strip - halo, 0), h - length)
        lo, hi = s * strip, min((s + 1) * strip, h)
        ge = torch.zeros_like(g[:, start:start + length])
        ge[:, lo - start:hi - start] = g[:, lo:hi]
        dx, dp = _grads(plain, x[:, start:start + length], params, ge, needs)
        if dx is not None:
            gx[:, start:start + length] += dx
        if dp is not None:
            gp = dp if gp is None else gp + dp
    return gx, gp


def vjp(plain: Plain, halo: int, x, params, g, needs=(True, True)):
    """What the backward op returns: the plain form's gradient,
    directly up to DIRECT_ROWS rows and strip by strip above."""
    if x.shape[1] <= DIRECT_ROWS:
        return _grads(plain, x, params, g, needs)
    return strip_vjp(plain, halo, x, params, g, needs, STRIP)


@contextlib.contextmanager
def _autograd_on():
    """Autograd inside a custom op's implementation, which the dispatcher
    calls with the autograd keys excluded: they are taken out of the
    thread's excluded set for the block, and grad mode is on."""
    exclude = torch._C._dispatch_tls_local_exclude_set().remove(
        torch._C.DispatchKey.AutogradFunctionality)
    with torch._C._ForceDispatchKeyGuard(
            torch._C._dispatch_tls_local_include_set(), exclude), \
            torch.enable_grad():
        yield


def windowed_op(name: str, plain: Plain, n_params: int, halo: int,
                on_launch: Callable[[int], None], backward_kernel: tuple):
    """Define reconfigisp::<name> and its backward op (module docstring).
    `on_launch(n)` adds n launches to the kernel's count: called with 1
    after each launch, and nowhere else (not on the CPU, not under fake
    tensors; within tally_launches() the launch is tallied there instead),
    and with a replay's tally by count_launches.  `backward_kernel` is
    (launch, on_launch): launch(x, params, g) -> (gx, gp, launches) runs the
    backward kernel for a CUDA input in place of `vjp`, and its launches are
    counted as the forward's, under `<name>.backward`.  -> the forward
    op."""
    _on_launch[name] = on_launch
    _on_launch[f"{name}.backward"] = backward_kernel[1]

    @torch.library.custom_op(f"reconfigisp::{name}", mutates_args=())
    def forward(x: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
        if x.device.type == "cuda":
            out = _build.launch(name, x, params, n_params)
            _launched(name)
            return out
        return plain(x, params).contiguous()

    @forward.register_fake
    def _(x, params):
        _build.check(name, x, params, n_params)
        return x.new_empty(x.shape)

    @torch.library.custom_op(f"reconfigisp::{name}_backward",
                             mutates_args=())
    def backward(x: torch.Tensor, params: torch.Tensor, g: torch.Tensor,
                 need_x: bool, need_p: bool) -> tuple[torch.Tensor,
                                                      torch.Tensor]:
        with tracing.span(f"{name}.backward", device=x.is_cuda):
            if x.is_cuda:
                gx, gp, launches = backward_kernel[0](x, params, g)
                _launched(f"{name}.backward", launches)
                gx, gp = (gx if need_x else None), (gp if need_p else None)
            else:
                with _autograd_on():
                    gx, gp = vjp(plain, halo, x, params, g, (need_x, need_p))
        # an input that needs no gradient, or that the output does not
        # depend on (the median's params), gets zeros here and None below
        gx = torch.zeros_like(x) if gx is None else gx
        gp = torch.zeros_like(params) if gp is None else gp
        return gx.contiguous(), gp.contiguous()

    @backward.register_fake
    def _(x, params, g, need_x, need_p):
        return x.new_empty(x.shape), params.new_empty(params.shape)

    def setup_context(ctx, inputs, output):
        # The inputs are kept as attributes, not saved tensors: a checkpoint
        # around the op (the supernet's per-op remat) then has nothing to
        # recompute, where its recompute would launch the kernel again to
        # rebuild inputs that it holds anyway.  Their versions stand in for
        # saved tensors' check against in-place changes.
        ctx.inputs = inputs
        ctx.versions = [t._version for t in inputs]

    def differentiate(ctx, g):
        x, params = ctx.inputs
        if [t._version for t in ctx.inputs] != ctx.versions:
            raise RuntimeError(f"an input of reconfigisp::{name} was "
                               "modified in place before its backward")
        need_x, need_p = ctx.needs_input_grad
        gx, gp = backward(x, params, g, need_x, need_p)
        return (gx if need_x else None), (gp if need_p else None)

    forward.register_autograd(differentiate, setup_context=setup_context)
    return forward


def plain_here(op: str, x: torch.Tensor, params: torch.Tensor) -> bool:
    """Whether a wrapper computes the plain form itself rather than call its
    op: for a CPU tensor that autograd differentiates outside a traced
    program, so that the gradient is the plain form's own autograd graph.
    Raises for a device other than cuda and cpu."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{op} runs on cuda or cpu, not {x.device}")
    return (x.device.type == "cpu" and torch.is_grad_enabled()
            and (x.requires_grad or params.requires_grad)
            and not torch.compiler.is_compiling())

"""Autograd for the hand-written kernels: the kernel forward, the plain backward.

Counterpart of reconfigisp_tpu/ops/denoise.py:_make_hybrid and _strip_vjp.
The JAX package has no backward kernel: its custom_vjp differentiates the jnp
form.  So here `WindowedKernel` launches the Hopper kernel in the forward
(_build.launch) and saves x and params; its backward recomputes the plain
PyTorch form from them under autograd and returns that form's gradient:
directly for a frame of at most DIRECT_ROWS rows, and above that strip by
strip (`strip_vjp`), which bounds the plain form's tap residuals at
STRIP + 2 halo rows.  On the same saved inputs the direct gradient is the
plain form's own, bit for bit: the plain forms pad by slices and flips
(ops/nn.reflect), so their backward adds in a fixed order.

The backward is once differentiable, as the DARTS step needs: it
differentiates each kernel once.  `vjp` and `strip_vjp` are plain functions
of the plain form, so the CPU tests reach the code the backward runs.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.autograd.function import once_differentiable

from reconfigisp_tpu_torch.ops.kernels import _build

DIRECT_ROWS = 640  # direct backward up to this many rows (_VJP_DIRECT_ROWS)
STRIP = 256        # output rows a chunk of the strip backward owns

Plain = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


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
    """What WindowedKernel's backward returns: the plain form's gradient,
    directly up to DIRECT_ROWS rows and strip by strip above."""
    if x.shape[1] <= DIRECT_ROWS:
        return _grads(plain, x, params, g, needs)
    return strip_vjp(plain, halo, x, params, g, needs, STRIP)


class WindowedKernel(torch.autograd.Function):
    """apply(x, params, name, plain, n_params, halo): csrc/<name>.cu forward,
    `plain`'s gradient backward."""

    @staticmethod
    def forward(ctx, x, params, name: str, plain: Plain, n_params: int,
                halo: int):
        ctx.save_for_backward(x, params)
        ctx.plain, ctx.halo = plain, halo
        return _build.launch(name, x, params, n_params)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, params = ctx.saved_tensors
        gx, gp = vjp(ctx.plain, ctx.halo, x, params, g,
                     tuple(ctx.needs_input_grad[:2]))
        return gx, gp, None, None, None, None

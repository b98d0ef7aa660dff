"""Median filter: the Hopper kernel's wrapper and its plain PyTorch form.

The kernel (csrc/median.cu) replaces the TPU kernel
reconfigisp_tpu/ops/pallas_kernels.py:median_pallas.  `median` launches it
for a CUDA tensor and counts the launch in `launches`; for a tensor on the
CPU it computes `median_plain`, the form of
reconfigisp_tpu/ops/denoise.py:_median_jnp, which is also the kernel's
reference on the card.  Both select the exact middle tap, so they agree bit
for bit: the kernel by pruned selection networks in registers, shared by
each 2x2 block of pixels, at radii up to 4, and by a bisection on the
float's order-preserving key above (tests/test_torch_windowed.py emulates
both on the CPU).  On CUDA the kernel runs inside an autograd Function
(_vjp.WindowedKernel) whose backward is median_plain's gradient, so a CUDA
input that requires grad launches the kernel too.  The params set only the
radius, an integer, so no gradient reaches them, on either path.

x (N, H, W, C) float32 in [0, 1]; params (N, 1) in [0, 1]: [size01].  The
radius clip(floor(7 size01), 0, 6) + 1 comes from params[0, 0] for the whole
batch, as in the JAX package.
"""

from __future__ import annotations

import torch

from reconfigisp_tpu_torch.ops.kernels import _build
from reconfigisp_tpu_torch.ops.kernels._vjp import WindowedKernel
from reconfigisp_tpu_torch.ops.kernels.bilateral import (
    pad_reflect, size01_to_radius)
from reconfigisp_tpu_torch.ops.nn import clip

STRIP = 64  # rows per tap stack in the plain form, as _median_fixed
HALO = _build.MAX_R  # rows of input one output row reaches

launches = 0  # kernel launches since the caller last set it to 0


def median_plain(x: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """The K = (2r+1)^2 taps of a strip of rows stacked, and the
    (K//2 + 1)-th smallest taken over them.  Strips bound the stack at K x
    STRIP rows, as _median_fixed does.  The gradient is _median_taps': the
    taps times their equality mask over its count, so that the cotangent is
    split equally among exact ties (kthvalue's own backward sends it all to
    one of them).  The value stays kthvalue's, bit for bit, as the kernel's;
    _median_taps' own sum can round a tie by an ulp (ROADMAP, faults)."""
    n, h, w, c = x.shape
    r = int(size01_to_radius(params[0, 0]))
    padded = pad_reflect(x, r)
    k2 = (2 * r + 1) ** 2
    out = torch.empty_like(x)
    for y0 in range(0, h, STRIP):
        rows = min(STRIP, h - y0)
        taps = torch.stack([padded[:, y0 + r + dy:y0 + r + dy + rows,
                                   r + dx:r + dx + w, :]
                            for dy in range(-r, r + 1)
                            for dx in range(-r, r + 1)])
        med = torch.kthvalue(taps.detach(), k2 // 2 + 1, dim=0).values
        if taps.requires_grad:
            mask = (taps.detach() == med).to(taps.dtype)
            tied = (taps * mask).sum(0) / mask.sum(0)
            med = med + (tied - tied.detach())  # med's value, bit for bit
        out[:, y0:y0 + rows] = med
    return clip(out, 0.0, 1.0)


def median(x: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel for a CUDA tensor, the plain form for a CPU tensor.
    The kernel reads contiguous NHWC, so other strides are copied first."""
    global launches
    if not _build.on_card("median", x, params):
        return median_plain(x, params)
    out = WindowedKernel.apply(x, params.detach(), "median", median_plain, 1,
                               HALO)
    launches += 1
    return out

"""Median filter: the Hopper kernel's wrapper and its plain PyTorch form.

The kernel (csrc/median.cu) replaces the TPU kernel
reconfigisp_tpu/ops/pallas_kernels.py:median_pallas.  It is the custom op
`reconfigisp::median` (_vjp.windowed_op), which launches the kernel for a
CUDA tensor and counts the launch in `launches`, and for a tensor on the CPU
computes `median_plain`, the form of
reconfigisp_tpu/ops/denoise.py:_median_jnp, which is also the kernel's
reference on the card; `median` calls the op, except for a CPU input that
autograd differentiates, which runs median_plain itself.  Both select the
exact middle tap, so they agree bit for bit: the kernel by pruned selection
networks in registers, shared by each 2x2 block of pixels, at radii up to
4, and by a bisection on the float's order-preserving key above
(tests/test_torch_windowed_median.py emulates both on the CPU).  The op's
backward is median_plain's gradient: on the card a backward kernel of its
own (csrc/median.cu's median_backward, `backward_launches` its launches),
which selects the median again and sums the tie-split cotangent in another
order, within 1e-4 of the largest gradient value
(tests/test_torch_median_backward.py emulates it on the CPU); on the CPU
the plain form's autograd (_vjp.vjp).  So a CUDA input that requires grad
launches the forward kernel too.  The params set only the radius, an
integer, so no gradient reaches them, on either path.

x (N, H, W, C) float32 in [0, 1]; params (N, 1) in [0, 1]: [size01].  The
radius clip(floor(7 size01), 0, 6) + 1 comes from params[0, 0] for the whole
batch, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch

from reconfigisp_tpu_torch.ops.kernels import _build
from reconfigisp_tpu_torch.ops.kernels import _vjp
from reconfigisp_tpu_torch.ops.kernels.bilateral import (
    pad_reflect, size01_to_radius)
from reconfigisp_tpu_torch.ops.nn import clip

STRIP = 64  # rows per tap stack in the plain form, as _median_fixed
MAX_R = _build.MAX_R
HALO = MAX_R  # rows of input one output row reaches

launches = 0  # kernel launches since the caller last set it to 0
backward_launches = 0  # backward kernel launches, the same way

# Integer min/max instructions of csrc/median.cu's pruned selection networks
# for one 2x2 block of pixels and one channel, by radius (its source note;
# tests/test_torch_windowed_median.py counts them in its mirror of the
# networks, tests/test_torch_cuda_build.py holds the SASS to them).  Larger
# radii bisect.
MEDIAN_NETWORK_MINMAX = {1: 114, 2: 412, 3: 952, 4: 1724}


def _median_fixed(x: torch.Tensor, r: int) -> torch.Tensor:
    """The median of the (2r+1)^2 window at a radius r known on the host,
    before the clip."""
    n, h, w, c = x.shape
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
    return out


def median_plain(x: torch.Tensor, params: torch.Tensor,
                 static: Optional[bool] = None) -> torch.Tensor:
    """The K = (2r+1)^2 taps of a strip of rows stacked, and the
    (K//2 + 1)-th smallest taken over them.  Strips bound the stack at K x
    STRIP rows, as _median_fixed does.  The gradient is _median_taps': the
    taps times their equality mask over its count, so that the cotangent is
    split equally among exact ties (kthvalue's own backward sends it all to
    one of them).  The value stays kthvalue's, bit for bit, as the kernel's;
    _median_taps' own sum can round a tie by an ulp (ROADMAP, faults).

    On the capture-safe route (_vjp.bounds_static, or `static`) the radius
    is not read on the host: all MAX_R radii are computed and torch.where
    takes the one of index clip(floor(7 p), 0, 6), on the device, as
    _median_jnp's lax.switch does.  The one taken is the host-read route's
    value and tie-split gradient bit for bit; the others get a zero
    cotangent."""
    radius = size01_to_radius(params[0, 0])
    if not _vjp.bounds_static(x, static):
        return clip(_median_fixed(x, int(radius)), 0.0, 1.0)
    out = _median_fixed(x, 1)
    for r in range(2, MAX_R + 1):
        out = torch.where(radius == r, _median_fixed(x, r), out)
    return clip(out, 0.0, 1.0)


def _count(n: int) -> None:
    global launches
    launches += n


def _count_backward(n: int) -> None:
    global backward_launches
    backward_launches += n


def backward_kernel(x: torch.Tensor, params: torch.Tensor, g: torch.Tensor):
    """The backward kernel on CUDA tensors -> (gx, gp, launches); gp is
    exactly 0."""
    return _build.launch_backward("median", x, params, g, 1)


op = _vjp.windowed_op("median", median_plain, 1, HALO, _count,
                      (backward_kernel, _count_backward))


def median(x: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """The op (the CUDA kernel for a CUDA tensor, the plain form for a CPU
    tensor), or median_plain itself where _vjp.plain_here says so."""
    if _vjp.plain_here("median", x, params):
        return median_plain(x, params)
    return op(x, params.detach())

"""Bilateral filter: the Hopper kernel's wrapper and its plain PyTorch form.

The kernel (csrc/bilateral.cu) replaces the TPU kernel
reconfigisp_tpu/ops/pallas_kernels.py:bilateral_pallas.  It is the custom
op `reconfigisp::bilateral` (_vjp.windowed_op), which launches the kernel
for a CUDA tensor and counts the launch in `launches`, and for a tensor on
the CPU computes `bilateral_plain`, the same function in PyTorch (the form
of reconfigisp_tpu/ops/denoise.py:_bilateral_jnp), which is also the
kernel's reference on the card.  The op's backward is bilateral_plain's
gradient: on the card a backward kernel of its own (csrc/bilateral.cu's
bilateral_backward, `backward_launches` its launches), which recomputes y
and the clip's mask in the plain form's arithmetic and sums the gradient
in another order, within 1e-4 of the largest gradient value; on the CPU
the plain form's autograd (_vjp.vjp), where HALO is the rows of input one
output row reaches, for the strip backward.  So a CUDA input that requires
grad launches the forward kernel too.  `bilateral` calls the op, except for
a CPU input that autograd differentiates: that runs bilateral_plain itself
(_vjp.plain_here).

x (N, H, W, C) float32 in [0, 1]; params (N, 3) in [0, 1]:
[window01, sigma_color01, sigma_space01]; radius = clip(floor(7 window01),
0, 6) + 1 and sigma = 1 + 99 sigma01 on the 0..255 scale.
"""

from __future__ import annotations

from typing import Optional

import torch

from reconfigisp_tpu_torch.ops.kernels import _build
from reconfigisp_tpu_torch.ops.kernels import _vjp
from reconfigisp_tpu_torch.ops.nn import clip, reflect

MAX_R = _build.MAX_R
HALO = MAX_R

launches = 0  # kernel launches since the caller last set it to 0
backward_launches = 0  # backward kernel launches, the same way

# csrc/bilateral.cu's kRows: output rows a thread owns.  A body's SASS holds
# one column offset's taps, BILATERAL_ROWS (2R+1) C MUFU.EX2 (its loop over
# the 2R+1 column offsets is not unrolled), so a thread issues (2R+1)^2 C of
# them per output row: one exp per tap.
BILATERAL_ROWS = 8


def size01_to_radius(p: torch.Tensor) -> torch.Tensor:
    """[0,1] -> integer radius in {1..7} (window {3..15})."""
    return torch.clamp(torch.floor(p * 7.0), 0, 6).to(torch.int32) + 1


def pad_reflect(x: torch.Tensor, r: int) -> torch.Tensor:
    """NHWC reflect padding (the edge pixel is not repeated)."""
    return reflect(reflect(x, r, 1), r, 2)


def bilateral_plain(x: torch.Tensor, params: torch.Tensor,
                    static: Optional[bool] = None) -> torch.Tensor:
    """Tap loop over column offsets (outer) and row offsets (inner), as
    _bilateral_jnp sums them.  Offsets beyond the largest radius in the batch
    carry zero weight for every image and are not visited; on the
    capture-safe route (_vjp.bounds_static, or `static`) the loop runs to
    MAX_R, as _bilateral_jnp's does, since that radius is not read on the
    host: the taps it adds have weight exactly 0 and add exact zeros to the
    sums and to every gradient, so value and gradients are the same bit for
    bit."""
    n, h, w, c = x.shape
    radius = size01_to_radius(params[:, 0])[:, None, None, None]
    sigma_color = (1.0 + 99.0 * params[:, 1])[:, None, None, None]
    sigma_space = (1.0 + 99.0 * params[:, 2])[:, None, None, None]
    inv_2sc2 = 0.5 / (sigma_color ** 2)
    inv_2ss2 = 0.5 / (sigma_space ** 2)
    x255 = x * 255.0
    padded = pad_reflect(x255, MAX_R)
    r_max = MAX_R if _vjp.bounds_static(x, static) else int(radius.max())
    num = torch.zeros_like(x255)
    den = torch.zeros_like(x255)
    for dx in range(-r_max, r_max + 1):
        for dy in range(-r_max, r_max + 1):
            tap = padded[:, MAX_R + dy:MAX_R + dy + h,
                         MAX_R + dx:MAX_R + dx + w, :]
            include = (max(abs(dy), abs(dx)) <= radius).to(x.dtype)
            w_space = torch.exp(-(dy * dy + dx * dx) * inv_2ss2)
            w_color = torch.exp(-((tap - x255) ** 2) * inv_2sc2)
            wgt = include * w_space * w_color
            num = num + wgt * tap
            den = den + wgt
    out = num / clip(den, 1e-8)
    return clip(out / 255.0, 0.0, 1.0)


def _count(n: int) -> None:
    global launches
    launches += n


def _count_backward(n: int) -> None:
    global backward_launches
    backward_launches += n


def backward_kernel(x: torch.Tensor, params: torch.Tensor, g: torch.Tensor):
    """The backward kernel on CUDA tensors -> (gx, gp, launches)."""
    return _build.launch_backward("bilateral", x, params, g, 3)


op = _vjp.windowed_op("bilateral", bilateral_plain, 3, HALO, _count,
                      (backward_kernel, _count_backward))


def bilateral(x: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """The op (the CUDA kernel for a CUDA tensor, the plain form for a CPU
    tensor), or bilateral_plain itself where _vjp.plain_here says so."""
    if _vjp.plain_here("bilateral", x, params):
        return bilateral_plain(x, params)
    return op(x, params)

"""Bilateral filter: the Hopper kernel's wrapper and its plain PyTorch form.

The kernel (csrc/bilateral.cu) replaces the TPU kernel
reconfigisp_tpu/ops/pallas_kernels.py:bilateral_pallas.  `bilateral` is the
one place that chooses: it launches the kernel for a CUDA tensor and counts
the launch in `launches`; for a tensor on the CPU it computes
`bilateral_plain`, the same function in PyTorch (the form of
reconfigisp_tpu/ops/denoise.py:_bilateral_jnp), which is also the kernel's
reference on the card.  On CUDA the kernel runs inside an autograd Function
(_vjp.WindowedKernel) whose backward is bilateral_plain's gradient, so a
CUDA input that requires grad launches the kernel too; HALO is the rows of
input one output row reaches, for the strip backward.

x (N, H, W, C) float32 in [0, 1]; params (N, 3) in [0, 1]:
[window01, sigma_color01, sigma_space01]; radius = clip(floor(7 window01),
0, 6) + 1 and sigma = 1 + 99 sigma01 on the 0..255 scale.
"""

from __future__ import annotations

import torch

from reconfigisp_tpu_torch.ops.kernels import _build
from reconfigisp_tpu_torch.ops.kernels._vjp import WindowedKernel
from reconfigisp_tpu_torch.ops.nn import clip, reflect

MAX_R = _build.MAX_R
HALO = MAX_R

launches = 0  # kernel launches since the caller last set it to 0


def size01_to_radius(p: torch.Tensor) -> torch.Tensor:
    """[0,1] -> integer radius in {1..7} (window {3..15})."""
    return torch.clamp(torch.floor(p * 7.0), 0, 6).to(torch.int32) + 1


def pad_reflect(x: torch.Tensor, r: int) -> torch.Tensor:
    """NHWC reflect padding (the edge pixel is not repeated)."""
    return reflect(reflect(x, r, 1), r, 2)


def bilateral_plain(x: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """Tap loop over column offsets (outer) and row offsets (inner), as
    _bilateral_jnp sums them.  Offsets beyond the largest radius in the batch
    carry zero weight for every image and are not visited."""
    n, h, w, c = x.shape
    radius = size01_to_radius(params[:, 0])[:, None, None, None]
    sigma_color = (1.0 + 99.0 * params[:, 1])[:, None, None, None]
    sigma_space = (1.0 + 99.0 * params[:, 2])[:, None, None, None]
    inv_2sc2 = 0.5 / (sigma_color ** 2)
    inv_2ss2 = 0.5 / (sigma_space ** 2)
    x255 = x * 255.0
    padded = pad_reflect(x255, MAX_R)
    r_max = int(radius.max())
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


def bilateral(x: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel for a CUDA tensor, the plain form for a CPU tensor.
    The kernel reads contiguous NHWC, so other strides are copied first."""
    global launches
    if not _build.on_card("bilateral", x, params):
        return bilateral_plain(x, params)
    out = WindowedKernel.apply(x, params, "bilateral", bilateral_plain, 3,
                               HALO)
    launches += 1
    return out

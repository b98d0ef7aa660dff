"""Functional NN primitives at the JAX package's NHWC interface.

Counterpart of reconfigisp_tpu/ops/nn.py.  The public functions keep the
reference layout (NHWC activations, HWIO conv weights) so tests compare like
with like; the learned modules (ops/cnn.py) run NCHW inside.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Stride-1 'SAME' convolution: x (N,H,W,Cin), w (kh,kw,Cin,Cout) HWIO.

    A plain convolution stays with cuDNN, as the JAX package left it to XLA
    (reconfigisp_tpu/ops/cnn.py:36-43)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), b,
                 padding="same")
    return y.permute(0, 2, 3, 1)


@torch.no_grad()
def init_conv(conv: nn.Conv2d, generator: torch.Generator) -> nn.Conv2d:
    """Kaiming-uniform weight and bias in place, with torch.nn.Conv2d's
    default bounds (both sqrt(1/fan_in)), drawn from `generator`."""
    kh, kw = conv.kernel_size
    bound = math.sqrt(1.0 / (kh * kw * conv.in_channels))
    conv.weight.uniform_(-bound, bound, generator=generator)
    conv.bias.uniform_(-bound, bound, generator=generator)
    return conv


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """Depth-to-space on NHWC with torch.nn.PixelShuffle channel semantics:
    (N, H, W, C*r*r) -> (N, H*r, W*r, C), channel = c*r*r + i*r + j."""
    n, h, w, crr = x.shape
    c = crr // (r * r)
    x = x.reshape(n, h, w, c, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n, h * r, w * r, c)


def bayer_to_rggb(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 1) RGGB mosaic -> (N, H/2, W/2, 4) planes [R, G1, G2, B]."""
    n, h2, w2, _ = x.shape
    t = x[..., 0].reshape(n, h2 // 2, 2, w2 // 2, 2).permute(0, 1, 3, 2, 4)
    return t.reshape(n, h2 // 2, w2 // 2, 4)


def rggb_to_bayer(x: torch.Tensor) -> torch.Tensor:
    """Inverse of bayer_to_rggb: (N, h, w, 4) -> (N, 2h, 2w, 1)."""
    n, h, w, _ = x.shape
    t = x.reshape(n, h, w, 2, 2).permute(0, 1, 3, 2, 4)
    return t.reshape(n, 2 * h, 2 * w, 1)


def broadcast_params(params: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(N, P) parameter vectors -> (N, H, W, P) constant feature planes."""
    n, p = params.shape
    return params[:, None, None, :].expand(n, h, w, p)

"""Path-Restore-14L, the learned Bayer and sRGB denoisers.

Counterpart of reconfigisp_tpu/ops/cnn.py:114-176 (the SRCNN nets are not
ported yet).  The net is an nn.Module that runs NCHW inside: a 3x3 conv to 64
channels, six pre-activation residual blocks of two 64->64 3x3 convs, and a
3x3 conv out.  The apply functions keep the JAX package's NHWC interface.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

from reconfigisp_tpu_torch.ops.nn import (
    bayer_to_rggb, init_conv, pixel_shuffle)
from reconfigisp_tpu_torch.precision import cnn_storage_dtype

_WIDTH = 64
_BLOCKS = 6


def _conv3x3(cin: int, cout: int) -> nn.Conv2d:
    # skip_init: the weights are drawn from the pipeline's generator (or
    # loaded), never from the global RNG
    return skip_init(nn.Conv2d, cin, cout, 3, padding=1)


def _conv_s(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """conv honouring the storage policy (precision.py)."""
    dt = cnn_storage_dtype()
    if dt == torch.float32:
        return conv(x)
    return F.conv2d(x.to(dt), conv.weight.to(dt), conv.bias.to(dt),
                    padding=1)


class ResBlock(nn.Module):
    """Pre-activation residual block (reference path_14l_bayer_arch.py:6-21)."""

    def __init__(self):
        super().__init__()
        self.conv1 = _conv3x3(_WIDTH, _WIDTH)
        self.conv2 = _conv3x3(_WIDTH, _WIDTH)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _conv_s(F.relu(x), self.conv1)
        y = _conv_s(F.relu(y), self.conv2)
        return x + y


class PathRestore14(nn.Module):
    """Path-Restore-14L on NCHW features; output in the input's dtype."""

    def __init__(self, in_ch: int, out_ch: int, generator: torch.Generator):
        super().__init__()
        self.conv_first = _conv3x3(in_ch, _WIDTH)
        self.blocks = nn.ModuleList(ResBlock() for _ in range(_BLOCKS))
        self.conv_last = _conv3x3(_WIDTH, out_ch)
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                init_conv(m, generator)

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        in_dtype = feat.dtype
        y = _conv_s(feat, self.conv_first)
        for blk in self.blocks:
            y = blk(y)
        return _conv_s(F.relu(y), self.conv_last).to(in_dtype)


def path14_bayer(generator: torch.Generator) -> PathRestore14:
    """Bayer-domain net: 4 RGGB planes in, 4 out (path_14l_bayer_arch.py)."""
    return PathRestore14(4, 4, generator)


def path14_bgr(generator: torch.Generator) -> PathRestore14:
    """sRGB-domain net: 3 channels in and out (path_14l_bgr_arch.py)."""
    return PathRestore14(3, 3, generator)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def apply_path14_bayer(net: PathRestore14, x: torch.Tensor) -> torch.Tensor:
    """x (N,H,W,1) Bayer -> (N,H,W,1) Bayer: RGGB pack, net, pixel shuffle."""
    y = net(_nchw(bayer_to_rggb(x)))
    return pixel_shuffle(y.permute(0, 2, 3, 1), 2)


def apply_path14_bgr(net: PathRestore14, x: torch.Tensor) -> torch.Tensor:
    """x (N,H,W,3) BGR -> BGR.  The net runs in RGB order
    (reference path_14l_bgr_arch.py:64-65,84)."""
    y = net(_nchw(x.flip(-1)))
    return y.permute(0, 2, 3, 1).flip(-1)

"""Learned CNN modules: SRCNN-Res proxies, SRCNN demosaic, Path-Restore-14L.

Counterpart of reconfigisp_tpu/ops/cnn.py.  Each net is an nn.Module that
runs NCHW inside; the apply functions keep the JAX package's NHWC interface.
  * SRCNN-Res (the proxies): conv 9x9/64, 5x5/32, 5x5/3 with a residual,
    conditioned on the image's per-channel min/mean/max and the op's params
    broadcast to planes.  Its input always has 3 + 9 + MAX_PROXY_PARAMS
    channels; the columns past the op's own parameter count are zero at init
    and the params are zero-padded at apply.
  * SRCNN demosaic: RGGB pack, conv 9x9/64, 1x1/32, 5x5/12, pixel shuffle.
  * Path-Restore-14L: a 3x3 conv to 64 channels, six pre-activation residual
    blocks of two 64->64 3x3 convs, and a 3x3 conv out.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

from reconfigisp_tpu_torch.ops.nn import (
    bayer_to_rggb, broadcast_params, init_conv, pixel_shuffle)
from reconfigisp_tpu_torch.precision import cnn_storage_dtype

_WIDTH = 64
_BLOCKS = 6
MAX_PROXY_PARAMS = 5  # widest proxy: bm3d's 5 params


def _conv(cin: int, cout: int, k: int) -> nn.Conv2d:
    # skip_init: the weights are drawn from the pipeline's generator (or
    # loaded), never from the global RNG; "same" padding for odd k
    return skip_init(nn.Conv2d, cin, cout, k, padding=k // 2)


def _init_all(net: nn.Module, generator: torch.Generator) -> None:
    for m in net.modules():
        if isinstance(m, nn.Conv2d):
            init_conv(m, generator)


def _conv_s(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """conv honouring the storage policy (precision.py)."""
    dt = cnn_storage_dtype()
    if dt == torch.float32:
        return conv(x)
    return F.conv2d(x.to(dt), conv.weight.to(dt), conv.bias.to(dt),
                    padding=conv.padding)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


# ------------------------------------------------------------------ SRCNN

class SRCNNRes(nn.Module):
    """The proxy net: conv 9x9/64, 5x5/32, 5x5/3 on NCHW features
    (reference srcnn_res_arch.py:13-24); output in the input's dtype."""

    def __init__(self, n_params: int, generator: torch.Generator):
        super().__init__()
        cin = 3 + 9 + MAX_PROXY_PARAMS
        self.conv1 = _conv(cin, 64, 9)
        self.conv2 = _conv(64, 32, 5)
        self.conv3 = _conv(32, 3, 5)
        _init_all(self, generator)
        with torch.no_grad():  # unused conditioning channels stay zero
            self.conv1.weight[:, 3 + 9 + n_params:] = 0.0

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        y = F.relu(_conv_s(feat, self.conv1))
        y = F.relu(_conv_s(y, self.conv2))
        return _conv_s(y, self.conv3).to(feat.dtype)


class SRCNNDemosaic(nn.Module):
    """4 RGGB planes -> 12 planes: conv 9x9/64, 1x1/32, 5x5/12
    (reference srcnn_demosaic_arch.py:14-25).  The demosaic ops have no
    parameters, so no parameter planes are concatenated."""

    def __init__(self, generator: torch.Generator):
        super().__init__()
        self.conv1 = _conv(4, 64, 9)
        self.conv2 = _conv(64, 32, 1)
        self.conv3 = _conv(32, 12, 5)
        _init_all(self, generator)

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        y = F.relu(_conv_s(feat, self.conv1))
        y = F.relu(_conv_s(y, self.conv2))
        return _conv_s(y, self.conv3).to(feat.dtype)


def apply_srcnn_res(net: SRCNNRes, x: torch.Tensor, params) -> torch.Tensor:
    """x (N,H,W,3) BGR; params (N,P), P <= MAX_PROXY_PARAMS, or None."""
    n, h, w, _ = x.shape
    if params is None:
        params = x.new_zeros((n, 0))
    params = F.pad(params, (0, MAX_PROXY_PARAMS - params.shape[1]))
    cond = torch.cat([torch.amin(x, dim=(1, 2)), torch.mean(x, dim=(1, 2)),
                      torch.amax(x, dim=(1, 2)), params], dim=1)
    feat = torch.cat([x, broadcast_params(cond, h, w)], dim=-1)
    return x + net(_nchw(feat)).permute(0, 2, 3, 1)


def _grouped_conv(x: torch.Tensor, convs, relu: bool) -> torch.Tensor:
    """K same-shape convs on K channel groups of x as one grouped conv:
    weights and biases joined on the output channels, `groups` = K."""
    dt = cnn_storage_dtype()
    w = torch.cat([c.weight for c in convs]).to(dt)
    b = torch.cat([c.bias for c in convs]).to(dt)
    y = F.conv2d(x.to(dt), w, b, padding=convs[0].padding, groups=len(convs))
    return F.relu(y) if relu else y


def apply_srcnn_res_bank(nets, x: torch.Tensor,
                         params: torch.Tensor) -> torch.Tensor:
    """K SRCNN-Res proxies on one input, as one grouped conv stack.

    nets: K SRCNNRes; x (N,H,W,3) BGR; params (K, N, MAX_PROXY_PARAMS),
    each proxy's zero-padded.  -> (K, N, H, W, 3), slice k equal to
    apply_srcnn_res(nets[k], x, params[k]).  The counterpart of the JAX
    supernet's vmap over the stacked weights (reconfigisp_tpu/supernet.py:
    146-160): the K stacks' convs run as one conv per layer."""
    k = len(nets)
    n, h, w, _ = x.shape
    stats = torch.cat([torch.amin(x, dim=(1, 2)), torch.mean(x, dim=(1, 2)),
                       torch.amax(x, dim=(1, 2))], dim=1)
    cond = torch.cat([stats.expand(k, n, stats.shape[1]), params], dim=2)
    feat = torch.cat([x.permute(0, 3, 1, 2).expand(k, n, 3, h, w),
                      cond[..., None, None].expand(*cond.shape, h, w)], dim=2)
    feat = feat.transpose(0, 1).reshape(n, k * feat.shape[2], h, w)
    y = _grouped_conv(feat, [net.conv1 for net in nets], relu=True)
    y = _grouped_conv(y, [net.conv2 for net in nets], relu=True)
    y = _grouped_conv(y, [net.conv3 for net in nets], relu=False)
    y = y.to(x.dtype).reshape(n, k, 3, h, w).permute(1, 0, 3, 4, 2)
    return x + y


def apply_srcnn_demosaic(net: SRCNNDemosaic, x: torch.Tensor) -> torch.Tensor:
    """x (N,H,W,1) Bayer RGGB -> (N,H,W,3): RGGB pack, net, pixel shuffle."""
    y = net(_nchw(bayer_to_rggb(x)))
    return pixel_shuffle(y.permute(0, 2, 3, 1), 2)


# ------------------------------------------------------------ Path-Restore


class ResBlock(nn.Module):
    """Pre-activation residual block (reference path_14l_bayer_arch.py:6-21)."""

    def __init__(self):
        super().__init__()
        self.conv1 = _conv(_WIDTH, _WIDTH, 3)
        self.conv2 = _conv(_WIDTH, _WIDTH, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _conv_s(F.relu(x), self.conv1)
        y = _conv_s(F.relu(y), self.conv2)
        return x + y


class PathRestore14(nn.Module):
    """Path-Restore-14L on NCHW features; output in the input's dtype."""

    def __init__(self, in_ch: int, out_ch: int, generator: torch.Generator):
        super().__init__()
        self.conv_first = _conv(in_ch, _WIDTH, 3)
        self.blocks = nn.ModuleList(ResBlock() for _ in range(_BLOCKS))
        self.conv_last = _conv(_WIDTH, out_ch, 3)
        _init_all(self, generator)

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


def apply_path14_bayer(net: PathRestore14, x: torch.Tensor) -> torch.Tensor:
    """x (N,H,W,1) Bayer -> (N,H,W,1) Bayer: RGGB pack, net, pixel shuffle."""
    y = net(_nchw(bayer_to_rggb(x)))
    return pixel_shuffle(y.permute(0, 2, 3, 1), 2)


def apply_path14_bgr(net: PathRestore14, x: torch.Tensor) -> torch.Tensor:
    """x (N,H,W,3) BGR -> BGR.  The net runs in RGB order
    (reference path_14l_bgr_arch.py:64-65,84)."""
    y = net(_nchw(x.flip(-1)))
    return y.permute(0, 2, 3, 1).flip(-1)

"""Darknet/YOLOv3 graph as a torch module: init, forward, darknet weight IO.

Counterpart of reconfigisp_tpu/yolo/net.py (reference
codes/models/modules/yolo_v3_net.py:239-359).  `YoloNet` walks the block
list of yolo/cfg.py; it takes NHWC RGB in [0, 1] at its boundary, runs NCHW
inside, applies batch norm in its eval form and returns, as `apply_yolo`
does, one (head, anchors, classes) per yolo block, head (N, A, Gh, Gw, 5+C)
of raw (pre-sigmoid) predictions.  Weights are OIHW; the darknet binary
holds them so, and convert.yolo_weights_from_jax / yolo_weights_to_jax carry
the JAX package's HWIO pytree.  Every weight, batch-norm statistics
included, is a parameter, as every leaf of the JAX pytree is one to
yolo/train.pretrain_yolo's Adam.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

BN_FIELDS = ("beta", "gamma", "mean", "var")   # darknet's order


class ConvBlock(nn.Module):
    """conv (padding size // 2) -> eval batch norm or bias -> leaky 0.1."""

    def __init__(self, blk: dict, cin: int):
        super().__init__()
        cout, k = blk["filters"], blk["size"]
        self.stride = blk["stride"]
        self.pad = k // 2
        self.bn = bool(blk.get("batch_normalize"))
        self.leaky = blk.get("activation") == "leaky"
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        names = BN_FIELDS if self.bn else ("bias",)
        for name in names:
            setattr(self, name, nn.Parameter(torch.empty(cout)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x, self.weight, None if self.bn else self.bias,
                     self.stride, self.pad)
        if self.bn:
            scale = self.gamma * torch.rsqrt(self.var + 1e-5)
            y = ((y - self.mean[:, None, None]) * scale[:, None, None]
                 + self.beta[:, None, None])
        return F.leaky_relu(y, 0.1) if self.leaky else y


def _route_indices(i: int, blk: dict) -> list:
    return [l if l >= 0 else i + l for l in blk["layers"]]


class YoloNet(nn.Module):
    """The graph of a block list; its parameters are allocated, not set:
    build it through init_yolo or load_darknet_weights."""

    def __init__(self, blocks: List[dict], in_channels: int = 3):
        super().__init__()
        self.blocks = blocks
        self.convs = nn.ModuleDict()
        channels = [in_channels]
        for i, blk in enumerate(blocks):
            t = blk["type"]
            if t == "convolutional":
                self.convs[str(i)] = ConvBlock(blk, channels[-1])
                channels.append(blk["filters"])
            elif t == "route":
                channels.append(sum(channels[j + 1]
                                    for j in _route_indices(i, blk)))
            elif t in ("shortcut", "upsample", "yolo"):
                channels.append(channels[-1])
            else:
                raise ValueError(f"unknown block type {t}")

    def conv_blocks(self) -> List[ConvBlock]:
        """The conv blocks in graph order, the darknet file's order."""
        return [self.convs[str(i)] for i, b in enumerate(self.blocks)
                if b["type"] == "convolutional"]

    def forward(self, x: torch.Tensor) -> list:
        """x (N, H, W, 3) RGB -> [(head (N, A, Gh, Gw, 5+C), anchors,
        classes), ...]."""
        x = x.permute(0, 3, 1, 2)
        outputs, heads = [], []
        for i, blk in enumerate(self.blocks):
            t = blk["type"]
            if t == "convolutional":
                x = self.convs[str(i)](x)
            elif t == "shortcut":
                x = x + outputs[i + blk["from"]]
            elif t == "route":
                parts = [outputs[j] for j in _route_indices(i, blk)]
                x = parts[0] if len(parts) == 1 else torch.cat(parts, 1)
            elif t == "upsample":
                x = F.interpolate(x, scale_factor=2, mode="nearest")
            elif t == "yolo":
                n, _, gh, gw = x.shape
                c = blk["classes"]
                # channel a * (5 + C) + k, as apply_yolo's NHWC reshape
                # splits it: anchor major, field minor
                head = x.view(n, len(blk["mask"]), 5 + c, gh, gw).permute(
                    0, 1, 3, 4, 2)
                heads.append((head, [blk["anchors"][m] for m in blk["mask"]],
                               c))
            outputs.append(x)
        return heads


def init_yolo(blocks: List[dict], generator: Optional[torch.Generator] = None,
              in_channels: int = 3, device=None) -> YoloNet:
    """A YoloNet with _conv_init's distributions (weights and bias
    U(-b, b), b = sqrt(1 / (k^2 Cin)); batch norm gamma 1, beta 0, mean 0,
    var 1), drawn on the CPU from `generator`.  The draws are not JAX's
    PRNG stream; carry a JAX init over with convert.yolo_weights_from_jax
    or a darknet file."""
    net = YoloNet(blocks, in_channels)
    with torch.no_grad():
        for conv in net.conv_blocks():
            cout, cin, k, _ = conv.weight.shape
            bound = math.sqrt(1.0 / (k * k * cin))
            conv.weight.copy_((torch.rand(conv.weight.shape,
                                          generator=generator) * 2 - 1)
                              * bound)
            if conv.bn:
                conv.gamma.fill_(1.0)
                conv.beta.zero_()
                conv.mean.zero_()
                conv.var.fill_(1.0)
            else:
                conv.bias.copy_((torch.rand(cout, generator=generator) * 2
                                 - 1) * bound)
    return net.to(device) if device is not None else net


def load_darknet_weights(blocks: List[dict], path: str, in_channels: int = 3,
                         device=None) -> YoloNet:
    """A YoloNet from the binary darknet format (reference
    yolo_v3_net.py:271-322): 3 int32 major, minor, revision, a seen counter
    (int64 where major * 10 + minor >= 2, else int32), then per conv block
    [beta, gamma, mean, var | bias] and the OIHW weights.  Raises unless
    the file holds exactly the graph's floats."""
    with open(path, "rb") as f:
        major, minor, _ = np.fromfile(f, np.int32, 3)
        np.fromfile(f, np.int64 if major * 10 + minor >= 2 else np.int32, 1)
        data = np.fromfile(f, np.float32)
    net = YoloNet(blocks, in_channels)
    ptr = 0
    with torch.no_grad():
        for conv in net.conv_blocks():
            for name in (BN_FIELDS if conv.bn else ("bias",)) + ("weight",):
                p = getattr(conv, name)
                n = p.numel()
                if ptr + n > len(data):
                    raise ValueError(f"weight file mismatch: {path} holds "
                                     f"{len(data)} floats, the graph more")
                p.copy_(torch.from_numpy(data[ptr:ptr + n]).view(p.shape))
                ptr += n
    if ptr != len(data):
        raise ValueError(
            f"weight file mismatch: consumed {ptr} of {len(data)} floats")
    return net.to(device) if device is not None else net


def save_darknet_weights(net: YoloNet, path: str) -> None:
    """Inverse of load_darknet_weights, in the layout the JAX package's
    save_darknet_weights writes: header (0, 2, 0) and seen 0 as int64."""
    chunks = [np.asarray([0, 2, 0], np.int32).tobytes(),
              np.asarray([0], np.int64).tobytes()]
    for conv in net.conv_blocks():
        for name in (BN_FIELDS if conv.bn else ("bias",)) + ("weight",):
            chunks.append(getattr(conv, name).detach().cpu().numpy()
                          .astype(np.float32).tobytes())
    with open(path, "wb") as f:
        f.write(b"".join(chunks))


def frozen(net: YoloNet) -> YoloNet:
    """The net as a fixed evaluator: no parameter takes a gradient, so a
    loss through it differentiates its input only."""
    return net.requires_grad_(False).eval()

"""Histogram-conditioned ops: per-image parameters predicted by a small FC
net whose weights are the op's flat parameter vector.

Counterpart of reconfigisp_tpu/ops/conditional.py.  The flat vector holds,
in order, each layer's (cin, cout) weight and (cout,) bias, then a global
bias on the predicted parameters.  It is used raw (no sigmoid, no batch
repeat); the sigmoid goes on the FC output.  The input is the per-channel
histogram of the image, a count that carries no gradient; under a space
context (parallel/space.py) each row's counts, summed over the frame's
rows that the space group's windows own.
"""

from __future__ import annotations

import torch

from reconfigisp_tpu_torch.ops import color
from reconfigisp_tpu_torch.parallel import space

DEFAULT_IN_CHANNELS = (24, 16)  # 3 channels x 8 bins, then one hidden layer


def conditional_n_params(in_channels: tuple, out_channel: int) -> int:
    """Length of the flat parameter vector."""
    dims = list(in_channels) + [out_channel]
    return sum(dims[i] * dims[i + 1] + dims[i + 1]
               for i in range(len(dims) - 1)) + out_channel


def channel_histograms(x: torch.Tensor, bins: int) -> torch.Tensor:
    """(N, H, W, 3) -> (N, 3 * bins) counts of floor(x * bins), clipped into
    the bins, channel-major; detached."""
    n, rows, _, c = x.shape
    idx = torch.clamp(torch.floor(x.detach() * bins), 0, bins - 1).to(torch.int64)
    idx = idx + bins * torch.arange(c, device=x.device)
    if space.active():
        idx = idx + (c * bins) * torch.arange(
            n * rows, device=x.device).reshape(n, rows, 1, 1)
        counts = torch.bincount(idx.reshape(-1), minlength=n * rows * c * bins)
        return space.frame_sum(counts.reshape(n, rows, c * bins).to(x.dtype))
    idx = idx + (c * bins) * torch.arange(n, device=x.device)[:, None, None, None]
    counts = torch.bincount(idx.reshape(-1), minlength=n * c * bins)
    return counts.reshape(n, c * bins).to(x.dtype)


def fc_forward(x, flat_params, in_channels: tuple, out_channel: int):
    """Per-image op parameters in [0, 1], (N, out_channel)."""
    feat = channel_histograms(x, in_channels[0] // 3)
    dims = list(in_channels) + [out_channel]
    idx = 0
    for i in range(len(dims) - 1):
        cin, cout = dims[i], dims[i + 1]
        w = flat_params[idx:idx + cin * cout].reshape(cin, cout)
        idx += cin * cout
        b = flat_params[idx:idx + cout]
        idx += cout
        feat = feat @ w + b
        if i != len(dims) - 2:
            feat = torch.relu(feat)
    glob = flat_params[idx:idx + out_channel]
    return torch.sigmoid(glob[None, :] + feat)


def make_conditional(base_apply, out_channel: int,
                     in_channels: tuple = DEFAULT_IN_CHANNELS):
    """A base op whose per-image params come from the FC net."""

    def apply(x, params, weights=None):
        # params: the raw flat vector, or (N, total) whose row 0 is used
        flat = params if params.ndim == 1 else params[0]
        per_image = fc_forward(x, flat, in_channels, out_channel)
        return base_apply(x, per_image, weights)

    return apply


conditional_gamma = make_conditional(color.gamma, 1)
conditional_wb_manual = make_conditional(color.wb_manual, 3)
conditional_wb_quadratic = make_conditional(color.wb_quadratic, 30)

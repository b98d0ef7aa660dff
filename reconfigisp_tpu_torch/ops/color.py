"""Color ops: gamma and the white-balance family.

Counterpart of reconfigisp_tpu/ops/color.py.  All ops take NHWC BGR images in
[0, 1] and per-image parameters `params` (N, P) already squashed into [0, 1].
"""

from __future__ import annotations

import torch

from reconfigisp_tpu_torch.ops.nn import clip

GAMMA_MAX = 3.0  # params01=0.5 -> gamma 1.0 (identity); range [1/3, 3]


def gamma(x, params, weights=None):
    """y = x ** exponent, exponent log-uniform in [1/GAMMA_MAX, GAMMA_MAX]."""
    exponent = GAMMA_MAX ** (2.0 * params[:, 0] - 1.0)
    xc = clip(x, 1e-8, 1.0)
    return xc ** exponent[:, None, None, None]


def grayworld(x, params=None, weights=None):
    """Gray-world white balance; the gains are detached statistics."""
    ch_mean = torch.mean(x, dim=(1, 2), keepdim=True)
    target = torch.mean(ch_mean, dim=3, keepdim=True)
    gain = (target / clip(ch_mean, 1e-6)).detach()
    return clip(x * gain, 0.0, 1.0)


def wb_manual(x, params, weights=None):
    """Per-channel gains in [0, 5] (0.2 is the identity)."""
    gain = params * 5.0
    return clip(x * gain[:, None, None, :], 0.0, 1.0)


def wb_whiteworld(x, params, weights=None):
    """White-patch WB: each channel's (1 - r/2)-quantile is scaled to 1.
    The quantile is a detached order statistic; the gradient to r flows
    through the interpolation between neighbouring order statistics."""
    n, h, w, c = x.shape
    ratio = params[:, 0]
    srt = torch.sort(x.reshape(n, h * w, c), dim=1).values
    q = 1.0 - 0.5 * ratio
    pos = q * (h * w - 1)
    lo = torch.floor(pos).to(torch.int64)
    hi = torch.clamp(lo + 1, max=h * w - 1)
    frac = pos - lo.to(pos.dtype)
    v_lo = torch.gather(srt, 1, lo[:, None, None].expand(n, 1, c))[:, 0]
    v_hi = torch.gather(srt, 1, hi[:, None, None].expand(n, 1, c))[:, 0]
    white = (v_lo.detach() * (1 - frac[:, None])
             + v_hi.detach() * frac[:, None])
    gain = 1.0 / clip(white, 1e-3)
    return clip(x * gain[:, None, None, :], 0.0, 1.0)


def wb_quadratic(x, params, weights=None):
    """Quadratic colour transform: coefficients in [-5, 5] map the basis
    (B^2, G^2, R^2, BG, BR, GR, B, G, R, 1) to 3 output channels."""
    coef = (params * 10.0 - 5.0).reshape(-1, 3, 10)
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    outs = []
    for c in range(3):
        cc = [coef[:, c, k][:, None, None] for k in range(10)]
        yc = (cc[0] * b * b + cc[1] * g * g + cc[2] * r * r
              + cc[3] * b * g + cc[4] * b * r + cc[5] * g * r
              + cc[6] * b + cc[7] * g + cc[8] * r + cc[9])
        outs.append(yc)
    return clip(torch.stack(outs, dim=-1), 0.0, 1.0)


def skip(x, params=None, weights=None):
    """Identity."""
    return x

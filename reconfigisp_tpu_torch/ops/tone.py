"""Global tone-mapping ops: manual piecewise-linear, Reinhard, CryEngine and
Hable filmic curves.

Counterpart of reconfigisp_tpu/ops/tone.py.  Images are NHWC BGR in [0, 1];
params (N, P) are already squashed into [0, 1].  Luminance uses the BT.601
weights in BGR order.
"""

from __future__ import annotations

import torch

from reconfigisp_tpu_torch.ops.nn import clip

LUM_BGR = (0.114, 0.587, 0.299)


def _luminance(x: torch.Tensor) -> torch.Tensor:
    lum = torch.tensor(LUM_BGR, dtype=x.dtype, device=x.device)
    return (x @ lum)[..., None]  # (N, H, W, 1)


def _scale_by_luminance(x, l_in, l_out):
    ratio = l_out / clip(l_in, 1e-6)
    return clip(x * ratio, 0.0, 1.0)


def gtm_manual(x, params, weights=None, n_seg: int = 4):
    """Piecewise-linear curve over n_seg equal segments of [0, 1]; params
    (N, n_seg - 1) are the interior knot heights, the ends pinned to 0 and 1."""
    n = x.shape[0]
    zeros = torch.zeros((n, 1), dtype=x.dtype, device=x.device)
    ones = torch.ones((n, 1), dtype=x.dtype, device=x.device)
    ys = torch.cat([zeros, params, ones], dim=1)  # (N, n_seg + 1)
    seg = torch.clamp(torch.floor(x * n_seg), 0, n_seg - 1).to(torch.int64)
    knots = ys[:, None, None, :].expand(*x.shape[:3], n_seg + 1)
    y_lo = torch.gather(knots, 3, seg)
    y_hi = torch.gather(knots, 3, seg + 1)
    start_x = seg.to(x.dtype) / n_seg
    out = y_lo + (x - start_x) * n_seg * (y_hi - y_lo)
    return clip(out, 0.0, 1.0)


def tone_reinhard(x, params, weights=None):
    """Extended Reinhard operator.  params (N, 2): white point
    W = 0.5 + 3.5 p0 and key a = 0.05 + 0.85 p1;
    L' = a L / exp(mean(log L)), Lo = L'(1 + L'/W^2) / (1 + L')."""
    white = 0.5 + 3.5 * params[:, 0]
    key = 0.05 + 0.85 * params[:, 1]
    l_in = _luminance(x)
    log_avg = torch.exp(torch.mean(torch.log(clip(l_in, 1e-6)),
                                   dim=(1, 2, 3), keepdim=True))
    l_scaled = key[:, None, None, None] * l_in / log_avg
    w2 = (white ** 2)[:, None, None, None]
    l_out = l_scaled * (1.0 + l_scaled / w2) / (1.0 + l_scaled)
    return _scale_by_luminance(x, l_in, l_out)


def tone_crysis(x, params, weights=None):
    """CryEngine exponential: y = 1 - exp(-e x), e = 0.1 + 9.9 p0."""
    expo = (0.1 + 9.9 * params[:, 0])[:, None, None, None]
    return clip(1.0 - torch.exp(-expo * x), 0.0, 1.0)


def tone_filmic(x, params, weights=None):
    """Hable (Uncharted 2) filmic curve: y = hable(E x) / hable(W) with
    W = 0.5 + 10.5 p0 and E = 1 + 9 p1."""
    A, B, C, D, E, F = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30

    def hable(v):
        return ((v * (A * v + C * B) + D * E) / (v * (A * v + B) + D * F)) - E / F

    white = (0.5 + 10.5 * params[:, 0])[:, None, None, None]
    expo = (1.0 + 9.0 * params[:, 1])[:, None, None, None]
    y = hable(expo * x) / clip(hable(white), 1e-6)
    return clip(y, 0.0, 1.0)

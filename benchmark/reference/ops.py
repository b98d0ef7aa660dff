"""Plain PyTorch forms of the ISP ops that the benchmark's cells run.

The benchmark's own copy, written from the op definitions of ReconfigISP
(arXiv 2109.04760) as the port states them (NHWC, BGR, RGGB mosaics in
[0, 1], parameters in [0, 1] after a sigmoid).  It imports nothing of the
program, so a later change to the program cannot move it.  Where a choice of
formulation sets a gradient (a clip at its bound splits the gradient as a
minimum and a maximum do; the median splits its cotangent over exact ties;
white-balance gains carry no gradient), it is the one the method states.

Convolutions take a storage mode: "f32" (float32; TF32 is whatever the
caller's backend flags say), "bf16" (operands cast to bfloat16, the result
kept in bfloat16, as the configuration's CNN storage states), or "fp8"
(operands rounded through float8 e4m3 and computed in bfloat16: the control
below bfloat16).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

MAX_R = 7           # largest window radius of the windowed ops
MAX_PROXY_PARAMS = 5
LUM_BGR = (0.114, 0.587, 0.299)
GAMMA_MAX = 3.0


# ------------------------------------------------------------- primitives

def clip(x, lo=None, hi=None):
    """min(max(x, lo), hi) with tensor bounds: at an exact bound the
    gradient is split in two, as jnp.clip's is."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return torch.clamp(x, lo, hi)
    if lo is not None:
        x = torch.maximum(x, x.new_full((), lo))
    if hi is not None:
        x = torch.minimum(x, x.new_full((), hi))
    return x


def reflect(x, r: int, dim: int):
    """Reflect padding by r along dim, the edge not repeated."""
    n = x.shape[dim]
    return torch.cat([x.narrow(dim, 1, r).flip(dim), x,
                      x.narrow(dim, n - 1 - r, r).flip(dim)], dim)


def _fp8(t):
    return t.to(torch.float8_e4m3fn).to(torch.bfloat16)


def conv(x, w, b, storage: str = "f32"):
    """Stride-1 'same' convolution of NCHW x by OIHW w."""
    pad = w.shape[-1] // 2
    if storage == "f32":
        return F.conv2d(x.float(), w, b, padding=pad)
    if storage == "bf16":
        bf = torch.bfloat16
        return F.conv2d(x.to(bf), w.to(bf), b.to(bf), padding=pad)
    if storage == "fp8":
        return F.conv2d(_fp8(x), _fp8(w), b.to(torch.bfloat16), padding=pad)
    raise ValueError(f"storage {storage!r}")


def pack_rggb(x):
    """(N, H, W, 1) mosaic -> (N, 4, H/2, W/2) planes R, G1, G2, B."""
    return torch.stack([x[:, 0::2, 0::2, 0], x[:, 0::2, 1::2, 0],
                        x[:, 1::2, 0::2, 0], x[:, 1::2, 1::2, 0]], dim=1)


def unpack(y, c: int):
    """(N, 4c, h, w) with channel c*4 + 2i + j -> (N, 2h, 2w, c): pixel
    (2y + i, 2x + j) of channel c."""
    n, _, h, w = y.shape
    y = y.reshape(n, c, 2, 2, h, w).permute(0, 4, 2, 5, 3, 1)
    return y.reshape(n, 2 * h, 2 * w, c)


# ------------------------------------------------------------- CNNs

def path_restore(feat, convs, storage="f32"):
    """Path-Restore-14L on NCHW feat: a 3x3 conv to 64 channels, six
    pre-activation residual blocks of two 3x3 convs, a 3x3 conv out.
    convs: 14 (weight, bias) pairs in that order."""
    y = conv(feat, *convs[0], storage)
    for blk in range(6):
        t = conv(F.relu(y), *convs[1 + 2 * blk], storage)
        t = conv(F.relu(t), *convs[2 + 2 * blk], storage)
        y = y + t
    return conv(F.relu(y), *convs[13], storage).float()


def srcnn(feat, convs, storage="f32"):
    """Three convs with ReLUs between them (SRCNN-Res and the SRCNN
    demosaic)."""
    y = F.relu(conv(feat, *convs[0], storage))
    y = F.relu(conv(y, *convs[1], storage))
    return conv(y, *convs[2], storage).float()


def path_bayer(x, convs, storage="f32"):
    return unpack(path_restore(pack_rggb(x), convs, storage), 1)


def path_bgr(x, convs, storage="f32"):
    """The net runs in RGB order."""
    y = path_restore(x.flip(-1).permute(0, 3, 1, 2), convs, storage)
    return y.permute(0, 2, 3, 1).flip(-1)


def srcnn_demosaic(x, convs, storage="f32"):
    return unpack(srcnn(pack_rggb(x), convs, storage), 3)


def srcnn_res(x, params, convs, storage="f32"):
    """The proxy: conditioned on the image's per-channel min, mean and max
    and the op's params zero-padded to MAX_PROXY_PARAMS, with a residual."""
    n, h, w, _ = x.shape
    if params is None:
        params = x.new_zeros((n, 0))
    params = F.pad(params, (0, MAX_PROXY_PARAMS - params.shape[1]))
    cond = torch.cat([x.amin((1, 2)), x.mean((1, 2)), x.amax((1, 2)),
                      params], dim=1)
    feat = torch.cat([x.permute(0, 3, 1, 2),
                      cond[:, :, None, None].expand(n, cond.shape[1], h, w)],
                     dim=1)
    return x + srcnn(feat, convs, storage).permute(0, 2, 3, 1)


# ------------------------------------------------------------- demosaic

def _k(rows):
    return np.asarray(rows, np.float32).reshape(5, 5)


def _at(dy=0, dx=0):
    a = np.zeros((5, 5), np.float32)
    a[2 + dy, 2 + dx] = 1.0
    return a


def _stencils():
    """{method: {colour: [stencil at phase R, G1, G2, B]}} (Malvar-He-Cutler
    2004 for 'malvar')."""
    h2 = _k([0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, .5, 0, .5, 0,
             0, 0, 0, 0, 0, 0, 0, 0, 0, 0])
    x4 = _k([0, 0, 0, 0, 0, 0, .25, 0, .25, 0, 0, 0, 0, 0, 0,
             0, .25, 0, .25, 0, 0, 0, 0, 0, 0])
    c4 = _k([0, 0, 0, 0, 0, 0, 0, .25, 0, 0, 0, .25, 0, .25, 0,
             0, 0, .25, 0, 0, 0, 0, 0, 0, 0])
    g_rb = _k([0, 0, -1, 0, 0, 0, 0, 2, 0, 0, -1, 2, 4, 2, -1,
               0, 0, 2, 0, 0, 0, 0, -1, 0, 0]) / 8.0
    row = _k([0, 0, .5, 0, 0, 0, -1, 0, -1, 0, -1, 4, 5, 4, -1,
              0, -1, 0, -1, 0, 0, 0, .5, 0, 0]) / 8.0
    diag = _k([0, 0, -1.5, 0, 0, 0, 2, 0, 2, 0, -1.5, 0, 6, 0, -1.5,
               0, 2, 0, 2, 0, 0, 0, -1.5, 0, 0]) / 8.0
    d = _at()
    return {
        "nearest": {"r": [d, _at(0, -1), _at(-1, 0), _at(-1, -1)],
                    "g": [_at(0, 1), d, _at(-1, 1), _at(-1, 0)],
                    "b": [_at(1, 1), _at(1, 0), _at(0, 1), d]},
        "bilinear": {"r": [d, h2, h2.T, x4], "g": [c4, d, d, c4],
                     "b": [x4, h2.T, h2, d]},
        "malvar": {"r": [d, row, row.T, diag], "g": [g_rb, d, d, g_rb],
                   "b": [diag, row.T, row, d]},
    }


STENCILS = _stencils()


def demosaic(x, method: str):
    """(N, H, W, 1) RGGB -> (N, H, W, 3) BGR: the 12 stencils as one 5x5
    convolution of the reflect-padded mosaic, each output channel taken at
    its Bayer phase, clipped to [0, 1]."""
    bank = STENCILS[method]
    weight = torch.tensor(np.stack([bank[c][t] for c in "bgr"
                                    for t in range(4)])[:, None],
                          device=x.device, dtype=x.dtype)
    xp = reflect(reflect(x[..., 0][:, None], 2, 2), 2, 3)
    y = F.conv2d(xp, weight)                     # (N, 12, H, W)
    n, _, h, w = y.shape
    phase = ((torch.arange(h, device=x.device) % 2)[:, None] * 2
             + (torch.arange(w, device=x.device) % 2)[None, :])
    sel = F.one_hot(phase, 4).permute(2, 0, 1).to(x.dtype)   # (4, H, W)
    out = (y.reshape(n, 3, 4, h, w) * sel).sum(2)
    return clip(out.permute(0, 2, 3, 1), 0.0, 1.0)


# ------------------------------------------------------------- colour, tone

def gamma(x, p):
    e = GAMMA_MAX ** (2.0 * p[:, 0] - 1.0)
    return clip(x, 1e-8, 1.0) ** e[:, None, None, None]


def wb_manual(x, p):
    return clip(x * (5.0 * p)[:, None, None, :], 0.0, 1.0)


def wb_quadratic(x, p):
    """Output channel c = sum_k coef[c, k] basis_k, basis (B^2, G^2, R^2,
    BG, BR, GR, B, G, R, 1), coef = 10 p - 5."""
    coef = (10.0 * p - 5.0).reshape(-1, 3, 10)
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    basis = torch.stack([b * b, g * g, r * r, b * g, b * r, g * r, b, g, r,
                         torch.ones_like(b)], dim=-1)
    return clip(torch.einsum("nhwk,nck->nhwc", basis, coef), 0.0, 1.0)


def grayworld(x, p=None):
    mean = x.mean((1, 2), keepdim=True)
    gain = (mean.mean(3, keepdim=True) / clip(mean, 1e-6)).detach()
    return clip(x * gain, 0.0, 1.0)


def wb_whiteworld(x, p):
    """Each channel's (1 - p/2)-quantile, linearly interpolated between order
    statistics that carry no gradient, scaled to 1."""
    n, h, w, c = x.shape
    srt = torch.sort(x.reshape(n, h * w, c).detach(), dim=1).values
    pos = (1.0 - 0.5 * p[:, 0]) * (h * w - 1)
    lo = torch.floor(pos).long()
    hi = torch.clamp(lo + 1, max=h * w - 1)
    frac = (pos - lo.to(pos.dtype))[:, None]
    v_lo = torch.gather(srt, 1, lo[:, None, None].expand(n, 1, c))[:, 0]
    v_hi = torch.gather(srt, 1, hi[:, None, None].expand(n, 1, c))[:, 0]
    white = v_lo * (1 - frac) + v_hi * frac
    return clip(x * (1.0 / clip(white, 1e-3))[:, None, None, :], 0.0, 1.0)


def _luma(x):
    lum = torch.tensor(LUM_BGR, dtype=x.dtype, device=x.device)
    return (x * lum).sum(-1, keepdim=True)


def tone_reinhard(x, p):
    white = (0.5 + 3.5 * p[:, 0])[:, None, None, None]
    key = (0.05 + 0.85 * p[:, 1])[:, None, None, None]
    l_in = _luma(x)
    log_avg = torch.exp(torch.log(clip(l_in, 1e-6)).mean((1, 2, 3),
                                                          keepdim=True))
    ls = key * l_in / log_avg
    l_out = ls * (1.0 + ls / white ** 2) / (1.0 + ls)
    return clip(x * (l_out / clip(l_in, 1e-6)), 0.0, 1.0)


def tone_crysis(x, p):
    e = (0.1 + 9.9 * p[:, 0])[:, None, None, None]
    return clip(1.0 - torch.exp(-e * x), 0.0, 1.0)


def tone_filmic(x, p):
    A, B, C, D, E, Fc = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30

    def hable(v):
        return (v * (A * v + C * B) + D * E) / (v * (A * v + B) + D * Fc) \
            - E / Fc

    white = (0.5 + 10.5 * p[:, 0])[:, None, None, None]
    expo = (1.0 + 9.0 * p[:, 1])[:, None, None, None]
    return clip(hable(expo * x) / clip(hable(white), 1e-6), 0.0, 1.0)


def gtm_manual(x, p, n_seg: int = 4):
    """Piecewise-linear curve over n_seg equal segments, knots (0, p, 1)."""
    n = x.shape[0]
    ys = torch.cat([x.new_zeros((n, 1)), p, x.new_ones((n, 1))], dim=1)
    seg = torch.clamp(torch.floor(x * n_seg), 0, n_seg - 1).long()
    knots = ys[:, None, None, :].expand(*x.shape[:3], n_seg + 1)
    lo = torch.gather(knots, 3, seg)
    hi = torch.gather(knots, 3, seg + 1)
    return clip(lo + (x - seg.to(x.dtype) / n_seg) * n_seg * (hi - lo),
                0.0, 1.0)


# ------------------------------------------------------------- windowed ops

def radius(p):
    """[0, 1] -> window radius in 1..7."""
    return torch.clamp(torch.floor(p * 7.0), 0, 6).long() + 1


def bilateral(x, p):
    """Per-image window radius and colour and space sigmas (1 + 99 p on the
    0..255 scale); taps beyond an image's radius weigh 0."""
    n, h, w, c = x.shape
    rad = radius(p[:, 0])[:, None, None, None]
    isc = 0.5 / ((1.0 + 99.0 * p[:, 1]) ** 2)[:, None, None, None]
    iss = 0.5 / ((1.0 + 99.0 * p[:, 2]) ** 2)[:, None, None, None]
    x255 = x * 255.0
    padded = reflect(reflect(x255, MAX_R, 1), MAX_R, 2)
    rmax = int(rad.max())
    num = torch.zeros_like(x255)
    den = torch.zeros_like(x255)
    for dx in range(-rmax, rmax + 1):
        for dy in range(-rmax, rmax + 1):
            tap = padded[:, MAX_R + dy:MAX_R + dy + h,
                         MAX_R + dx:MAX_R + dx + w]
            wgt = ((max(abs(dy), abs(dx)) <= rad).to(x.dtype)
                   * torch.exp(-(dy * dy + dx * dx) * iss)
                   * torch.exp(-((tap - x255) ** 2) * isc))
            num = num + wgt * tap
            den = den + wgt
    return clip(num / clip(den, 1e-8) / 255.0, 0.0, 1.0)


def median(x, p):
    """Median of the (2r+1)^2 window, r from image 0's parameter; the
    cotangent is split equally over taps that tie with the median."""
    n, h, w, c = x.shape
    r = int(radius(p[0, 0]))
    padded = reflect(reflect(x, r, 1), r, 2)
    taps = torch.stack([padded[:, r + dy:r + dy + h, r + dx:r + dx + w]
                        for dy in range(-r, r + 1) for dx in range(-r, r + 1)])
    med = torch.kthvalue(taps.detach(), (2 * r + 1) ** 2 // 2 + 1, 0).values
    if taps.requires_grad:
        mask = (taps.detach() == med).to(x.dtype)
        tied = (taps * mask).sum(0) / mask.sum(0)
        med = med + (tied - tied.detach())
    return clip(med, 0.0, 1.0)


def _box(d, b: int):
    """(2b+1)^2 mean over NCHW with reflect padding, rows then columns."""
    k = 2 * b + 1
    h, w = d.shape[2:]
    rows = reflect(d, b, 2)
    acc = sum(rows[:, :, i:i + h] for i in range(k)) / k
    cols = reflect(acc, b, 3)
    return sum(cols[:, :, :, i:i + w] for i in range(k)) / k


def fastnlm(x, p):
    """Non-local means: block radius from image 0's parameter, per-image
    search radius and decay h = 1 + 99 p (0..255 scale)."""
    n, h, w, c = x.shape
    search = radius(p[:, 1])[:, None, None, None]
    inv_h2 = 1.0 / ((1.0 + 99.0 * p[:, 2]) ** 2)[:, None, None, None]
    b = int(radius(p[0, 0]))
    x255 = (x * 255.0).permute(0, 3, 1, 2)
    padded = reflect(reflect(x255, MAX_R, 2), MAX_R, 3)
    smax = int(search.max())
    num = torch.zeros_like(x255)
    den = torch.zeros_like(x255)
    for dx in range(-smax, smax + 1):
        for dy in range(-smax, smax + 1):
            tap = padded[:, :, MAX_R + dy:MAX_R + dy + h,
                         MAX_R + dx:MAX_R + dx + w]
            d2 = _box((tap - x255) ** 2, b)
            wgt = ((max(abs(dy), abs(dx)) <= search).to(x.dtype)
                   * torch.exp(-d2 * inv_h2))
            num = num + wgt * tap
            den = den + wgt
    out = (num / clip(den, 1e-8)).permute(0, 2, 3, 1)
    return clip(out / 255.0, 0.0, 1.0)


def skip(x, p=None):
    return x


def sigmoid_params(logits, n: int):
    """Per-op logits (P,) -> (n, P) params in [0, 1]."""
    return torch.sigmoid(logits)[None, :].expand(n, logits.shape[0])


"""Spatial denoising ops: bilateral, median and fast non-local means.

Counterpart of reconfigisp_tpu/ops/denoise.py.  Each op is its kernel
module's dispatcher (ops/kernels/): a CUDA tensor goes to the Hopper kernel,
a CPU tensor to the plain PyTorch form; there is no size gate and no switch.

Parameters in [0, 1], on the 0..255 intensity scale where a sigma or decay
is involved (reference tools_origin.py:673-804):
  bilateral (N, 3): [window01, sigma_color01, sigma_space01];
      window = 2*floor(window01*7)+3 in {3..15}, sigma = 1 + 99*sigma01.
  median (N, 1): [size01], window as above from params[0, 0] for the batch.
  fastnlm (N, 3): [block01, search01, decay01]; block from params[0, 0] for
      the batch, search per image, decay h = 1 + 99*decay01.
`dct_denoise`, the BM3D proxy's tuning target, is plain PyTorch matmuls:
the JAX package leaves it to XLA too (no Pallas kernel).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from reconfigisp_tpu_torch.ops.kernels.bilateral import bilateral
from reconfigisp_tpu_torch.ops.kernels.fastnlm import fastnlm
from reconfigisp_tpu_torch.ops.kernels.median import median

__all__ = ["bilateral", "dct_denoise", "fastnlm", "median"]


# ---------------------------------------------------------------------------
# BM3D stand-in (reconfigisp_tpu/ops/denoise.py:435-550): blockwise 2-D DCT
# or WHT, hard threshold of the AC coefficients, overlap-add over 4
# half-block-shifted covers.  The reference ships only a proxy pretrained
# against MATLAB BM3D (origin_universal.py:11-13); this gives the bm3d proxy a
# native target with the same 5 parameters.
# ---------------------------------------------------------------------------

def _dct_matrix(b: int) -> torch.Tensor:
    k = torch.arange(b, dtype=torch.float32)
    mat = math.sqrt(2.0 / b) * torch.cos(
        math.pi * (2.0 * k[None, :] + 1.0) * k[:, None] / (2.0 * b))
    mat[0] *= 1.0 / math.sqrt(2.0)
    return mat


def _wht_matrix(b: int) -> torch.Tensor:
    """Normalised Walsh-Hadamard (b a power of 2)."""
    h = torch.ones((1, 1))
    while h.shape[0] < b:
        h = torch.cat([torch.cat([h, h], 1), torch.cat([h, -h], 1)], 0)
    return h / math.sqrt(float(b))


# BM3D's opponent colour transform over RGB, and its inverse
_OPP = np.asarray([[1 / 3, 1 / 3, 1 / 3],
                   [0.5, 0.0, -0.5],
                   [0.25, -0.5, 0.25]], np.float32)
_OPP_INV = np.asarray([[1.0, 1.0, 2 / 3],
                       [1.0, 0.0, -4 / 3],
                       [1.0, -1.0, 2 / 3]], np.float32)


def _dct_denoise_fixed(x, thr, tmat, sparse_w, b: int):
    """x (N,H,W,C) on 0..255; thr (N,1,1,1,1,1); tmat (N,b,b); sparse_w (N,)
    in {0, 1}: sparsity-weighted (1) or uniform (0) aggregation."""
    n, h, w, c = x.shape
    h2 = b // 2
    hp = -(-(h + b) // b) * b
    wp = -(-(w + b) // b) * b
    xp = F.pad(x.permute(0, 3, 1, 2), (h2, wp - w - h2, h2, hp - h - h2),
               mode="reflect").permute(0, 2, 3, 1)
    num = torch.zeros_like(xp)
    den = torch.zeros_like(xp)
    hb, wb = hp - b, wp - b
    tmat_t = tmat.transpose(1, 2)
    dc = torch.zeros((b, b), dtype=torch.bool, device=x.device)
    dc[0, 0] = True   # the DC coefficient (the block's mean) always stays
    uniform = (sparse_w <= 0.5)[:, None, None, None, None, None]
    for oy in (0, h2):
        for ox in (0, h2):
            ys, xs = slice(h2 - oy, h2 - oy + hb), slice(h2 - ox, h2 - ox + wb)
            blocks = xp[:, ys, xs, :].reshape(n, hb // b, b, wb // b, b, c)
            # the 2-D transform T @ block @ T^T over the two b axes
            coef = torch.einsum("nvu,niujbc->nivjbc", tmat, blocks)
            coef = torch.einsum("nvu,niajuc->niajvc", tmat, coef)
            keep = (coef.abs() > thr) | dc[None, None, :, None, :, None]
            coef_t = torch.where(keep, coef, torch.zeros_like(coef))
            nkept = keep.to(x.dtype).sum(dim=(2, 4), keepdim=True)
            wgt = torch.where(uniform, torch.ones_like(nkept),
                              1.0 / (1.0 + nkept))
            rec = torch.einsum("nvu,niujbc->nivjbc", tmat_t, coef_t)
            rec = torch.einsum("nvu,niajuc->niajvc", tmat_t, rec)
            wfull = wgt.expand(n, hb // b, b, wb // b, b, c).reshape(
                n, hb, wb, c)
            num[:, ys, xs, :] += (rec * wgt).reshape(n, hb, wb, c)
            den[:, ys, xs, :] += wfull
    out = num / torch.clamp(den, min=1e-8)
    return out[:, h2:h2 + h, h2:h2 + w, :]


def dct_denoise(x, params, weights=None):
    """Transform-domain hard-threshold denoiser, the native target of the
    bm3d proxy.  x (N,H,W,C) in [0,1], C = 1 or 3 (BGR); params (N, 5):
      cff01          -> hard threshold 1 + 99 cff01 on the 0..255 scale;
      n101           -> block size 4 (< 0.5) or 8, from params[0, 1] for
                        the batch;
      cspace01       -> >= 0.5: in the opponent colour space (of RGB);
      wtransform01   -> >= 0.5: WHT and sparsity-weighted aggregation, else
                        DCT and uniform aggregation;
      neighborhood01 -> blend: out = x + blend (denoised - x).
    No gradient is asked of it (the proxy's target runs under no_grad)."""
    n, h, w, c = x.shape
    thr = (1.0 + 99.0 * params[:, 0]).reshape(n, 1, 1, 1, 1, 1)
    use_opp = (params[:, 2] >= 0.5) & (c == 3)
    use_wht = params[:, 3] >= 0.5
    blend = params[:, 4][:, None, None, None]
    x255 = x * 255.0
    if c == 3:
        eye = torch.eye(3, device=x.device)
        sel = use_opp[:, None, None]
        cmat = torch.where(sel, torch.from_numpy(_OPP).to(x.device), eye)
        cinv = torch.where(sel, torch.from_numpy(_OPP_INV).to(x.device), eye)
        xc = torch.einsum("nij,nhwj->nhwi", cmat, x255.flip(-1))
    else:
        xc = x255
    b = 8 if float(params[0, 1]) >= 0.5 else 4
    tm = torch.where(use_wht[:, None, None], _wht_matrix(b).to(x.device),
                     _dct_matrix(b).to(x.device))
    den = _dct_denoise_fixed(xc, thr, tm, use_wht.to(x.dtype), b)
    if c == 3:
        den = torch.einsum("nij,nhwj->nhwi", cinv, den).flip(-1)
    out = x255 + blend * (den - x255)
    return torch.clamp(out / 255.0, 0.0, 1.0)

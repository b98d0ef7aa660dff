"""Demosaicing ops: nearest, bilinear, Malvar-He-Cutler (laplacian).

Counterpart of reconfigisp_tpu/ops/demosaic.py.  The 5x5 kernel banks
(3 colours x 4 Bayer phases) are copied here; each colour is the four phase
stencils evaluated over the reflect-padded mosaic and blended with
Bayer-parity masks.

Input: (N, H, W, 1) RGGB mosaic in [0, 1].  Output: (N, H, W, 3) BGR.
Phase types: 0 = R site (even row, even col), 1 = G1 (even, odd),
2 = G2 (odd, even), 3 = B (odd, odd).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from reconfigisp_tpu_torch.ops.nn import clip


def _k(rows):
    return np.asarray(rows, np.float32).reshape(5, 5)


def _offset(dy=0, dx=0):
    a = np.zeros((5, 5), np.float32)
    a[2 + dy, 2 + dx] = 1.0
    return a


def _bank_nearest():
    """Quad-aligned nearest neighbour: every 2x2 quad reuses its own R/G1/B."""
    d = _offset()
    return {"r": [d, _offset(0, -1), _offset(-1, 0), _offset(-1, -1)],
            "g": [_offset(0, 1), d, _offset(-1, 1), _offset(-1, 0)],
            "b": [_offset(1, 1), _offset(1, 0), _offset(0, 1), d]}


def _bank_bilinear():
    h2 = _k([[0, 0, 0, 0, 0],
             [0, 0, 0, 0, 0],
             [0, .5, 0, .5, 0],
             [0, 0, 0, 0, 0],
             [0, 0, 0, 0, 0]])
    v2 = h2.T
    x4 = _k([[0, 0, 0, 0, 0],
             [0, .25, 0, .25, 0],
             [0, 0, 0, 0, 0],
             [0, .25, 0, .25, 0],
             [0, 0, 0, 0, 0]])
    cross4 = _k([[0, 0, 0, 0, 0],
                 [0, 0, .25, 0, 0],
                 [0, .25, 0, .25, 0],
                 [0, 0, .25, 0, 0],
                 [0, 0, 0, 0, 0]])
    d = _offset()
    return {"r": [d, h2, v2, x4],
            "g": [cross4, d, d, cross4],
            "b": [x4, v2, h2, d]}


def _bank_malvar():
    """Malvar-He-Cutler 2004 gradient-corrected linear kernels."""
    g_at_rb = _k([[0, 0, -1, 0, 0],
                  [0, 0, 2, 0, 0],
                  [-1, 2, 4, 2, -1],
                  [0, 0, 2, 0, 0],
                  [0, 0, -1, 0, 0]]) / 8.0
    row_k = _k([[0, 0, .5, 0, 0],
                [0, -1, 0, -1, 0],
                [-1, 4, 5, 4, -1],
                [0, -1, 0, -1, 0],
                [0, 0, .5, 0, 0]]) / 8.0
    col_k = row_k.T
    diag_k = _k([[0, 0, -1.5, 0, 0],
                 [0, 2, 0, 2, 0],
                 [-1.5, 0, 6, 0, -1.5],
                 [0, 2, 0, 2, 0],
                 [0, 0, -1.5, 0, 0]]) / 8.0
    d = _offset()
    return {"r": [d, row_k, col_k, diag_k],
            "g": [g_at_rb, d, d, g_at_rb],
            "b": [diag_k, col_k, row_k, d]}


_BANKS = {
    "nearest": _bank_nearest(),
    "bilinear": _bank_bilinear(),
    "malvar": _bank_malvar(),
}


def _demosaic_conv(x: torch.Tensor, bank) -> torch.Tensor:
    """Masked stencil evaluation over the reflect-padded mosaic, in the same
    order of operations as the JAX form (identical stencils are shared)."""
    n, h, w, _ = x.shape
    xp = F.pad(x[..., 0][:, None], (2, 2, 2, 2), mode="reflect")[:, 0]
    yy = (torch.arange(h, device=x.device) % 2)[:, None]
    xx = (torch.arange(w, device=x.device) % 2)[None, :]
    masks = [((yy == ty) & (xx == tx)).to(x.dtype)
             for ty, tx in ((0, 0), (0, 1), (1, 0), (1, 1))]

    cache = {}

    def stencil(k: np.ndarray):
        key = k.tobytes()
        if key in cache:
            return cache[key]
        acc = None
        for dy in range(-2, 3):
            for dx in range(-2, 3):
                wgt = float(k[dy + 2, dx + 2])
                if wgt == 0.0:
                    continue
                piece = xp[:, 2 + dy:2 + dy + h, 2 + dx:2 + dx + w]
                term = piece if wgt == 1.0 else piece * wgt
                acc = term if acc is None else acc + term
        cache[key] = acc
        return acc

    chans = []
    for cname in ("b", "g", "r"):
        acc = None
        for t in range(4):
            term = masks[t] * stencil(bank[cname][t])
            acc = term if acc is None else acc + term
        chans.append(acc)
    return clip(torch.stack(chans, dim=-1), 0.0, 1.0)


def demosaic_nearest(x, params=None, weights=None):
    return _demosaic_conv(x, _BANKS["nearest"])


def demosaic_bilinear(x, params=None, weights=None):
    return _demosaic_conv(x, _BANKS["bilinear"])


def demosaic_malvar(x, params=None, weights=None):
    return _demosaic_conv(x, _BANKS["malvar"])

"""Image and array housekeeping.

Counterpart of reconfigisp_tpu/utils/imaging.py (reference
codes/utils/util.py:59-139): experiment-dir archiving, sensor-state packing
and float -> uint8 BGR conversion, numpy only; and the OnePlus dataset's
Bayer-aware resize (reference oneplus_rggb2obj_dataset.py:109-147), through
`area_resize`, cv2's INTER_AREA downscale in numpy.
"""

from __future__ import annotations

import math
import os
import time

import numpy as np


def mkdir_and_rename(path: str) -> None:
    """Archive an existing experiment dir with a timestamp suffix, then
    create a fresh one (reference util.py:59-66)."""
    if os.path.exists(path):
        archived = path + "_archived_" + time.strftime("%y%m%d-%H%M%S")
        os.rename(path, archived)
    os.makedirs(path, exist_ok=True)


def state2tensor(state: np.ndarray, bit: int = 10) -> np.ndarray:
    """uint16 sensor state -> float in [0,1] (reference util.py:96-105)."""
    return state.astype(np.float32) / (2 ** bit - 1)


def tensor2state(t: np.ndarray, bit: int = 10) -> np.ndarray:
    """float [0,1] -> uint16 sensor state (reference util.py:107-115)."""
    return np.clip(np.round(t * (2 ** bit - 1)), 0,
                   2 ** bit - 1).astype(np.uint16)


def tensor2bgr(t) -> np.ndarray:
    """float [0,1] (H,W,3) or (N,H,W,3), numpy or a tensor -> uint8 BGR
    (reference util.py:118-138)."""
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.clip(np.round(np.asarray(t) * 255.0), 0, 255).astype(np.uint8)


def bayer_aware_resize(mosaic: np.ndarray, target: int,
                       return_extent: bool = False):
    """Downscale an RGGB mosaic by resizing each of its four phase planes
    with `area_resize` (cv2's INTER_AREA), then re-interleaving them, which keeps the CFA
    structure (reference oneplus_rggb2obj_dataset.py:109-147: per-channel
    resize to 1024 + zero padding).  Returns a (target, target, 1) mosaic,
    zero-padded below and right where the aspect ratio is not 1; with
    return_extent also the (th, tw) extent of the content, so callers can
    place the padding band (the reference centres it, :118-119)."""
    h, w = mosaic.shape[:2]
    m = mosaic[..., 0] if mosaic.ndim == 3 else mosaic
    scale = target / max(h, w)
    th = int(round(h * scale / 2)) * 2
    tw = int(round(w * scale / 2)) * 2
    planes = [m[0::2, 0::2], m[0::2, 1::2], m[1::2, 0::2], m[1::2, 1::2]]
    small = [area_resize(p, (th // 2, tw // 2)) for p in planes]
    out = np.zeros((th, tw), np.float32)
    out[0::2, 0::2] = small[0]
    out[0::2, 1::2] = small[1]
    out[1::2, 0::2] = small[2]
    out[1::2, 1::2] = small[3]
    padded = np.zeros((target, target), np.float32)
    padded[:th, :tw] = out
    if return_extent:
        return padded[..., None], (th, tw)
    return padded[..., None]


def _area_taps(n_in: int, n_out: int):
    """cv2's computeResizeAreaTab for one axis -> (index, weight), each
    (n_out, K): the source pixels an output pixel covers, in source order,
    with float32 weights (a partial pixel at either edge weighs its covered
    fraction, one under 1e-3 is dropped); short rows padded with weight 0."""
    scale = 1.0 / (n_out / n_in)
    taps = []
    for d in range(n_out):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, n_in - f1)
        s2 = min(math.floor(f2), n_in - 1)
        s1 = min(math.ceil(f1), s2)
        row = []
        if s1 - f1 > 1e-3:
            row.append((s1 - 1, (s1 - f1) / cell))
        row += [(s, 1.0 / cell) for s in range(s1, s2)]
        if f2 - s2 > 1e-3:
            row.append((s2, min(min(f2 - s2, 1.0), cell) / cell))
        taps.append(row)
    k = max(len(r) for r in taps)
    index = np.zeros((n_out, k), np.int64)
    weight = np.zeros((n_out, k), np.float32)
    for d, row in enumerate(taps):
        for t, (s, a) in enumerate(row):
            index[d, t], weight[d, t] = s, a
    return index, weight


def _fast_area(x: np.ndarray, sy: int, sx: int) -> np.ndarray:
    """cv2's resizeAreaFast for integer factors: each sy x sx block's sum in
    row-major order, four at a time, times float32 1 / (sy sx); 2x2 blocks of
    one or four channels as its SIMD lanes add them, (a + b) + (c + d)."""
    h, w = x.shape[0] // sy, x.shape[1] // sx
    blocks = x[:h * sy, :w * sx].reshape(h, sy, w, sx, *x.shape[2:])
    cells = [blocks[:, i, :, j] for i in range(sy) for j in range(sx)]
    scale = np.float32(1.0) / np.float32(sy * sx)
    c = x.shape[2] if x.ndim == 3 else 1
    if sy == sx == 2 and c in (1, 4):
        # the vector loop takes whole lanes of 4 floats; the rest is scalar
        vec = (w * c) // 4 * 4 // c
        out = ((cells[0] + cells[1]) + cells[2]) + cells[3]
        out[:, :vec] = (cells[0][:, :vec] + cells[1][:, :vec]) + (
            cells[2][:, :vec] + cells[3][:, :vec])
        return out * scale
    total = None
    for k in range(0, len(cells) - len(cells) % 4, 4):
        part = ((cells[k] + cells[k + 1]) + cells[k + 2]) + cells[k + 3]
        total = part if total is None else total + part
    for cell in cells[len(cells) - len(cells) % 4:]:
        total = cell if total is None else total + cell
    return total * scale


def area_resize(img: np.ndarray, size) -> np.ndarray:
    """cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA) for a float32
    (H, W) or (H, W, C) image and `size` (h, w) no larger than it: each
    output pixel the mean of the source area it covers, with fractional
    weights at the edges.  The arithmetic is cv2's, in its order and in
    float32 (a row's weighted sum across, then the rows' weighted sum), so
    the results are cv2's bit for bit; integer factors take cv2's block
    mean.  An upscale raises (cv2 interpolates there)."""
    img = np.asarray(img, np.float32)
    h, w = int(size[0]), int(size[1])
    H, W = img.shape[:2]
    if h > H or w > W or h < 1 or w < 1:
        raise ValueError(f"area_resize shrinks only: {H}x{W} to {h}x{w}")
    if (h, w) == (H, W):
        return img.copy()
    fy, fx = H / h, W / w
    if fy == int(fy) and fx == int(fx):
        return _fast_area(img, int(fy), int(fx))
    out = None
    xi, xw = _area_taps(W, w)
    for t in range(xi.shape[1]):
        wt = xw[:, t] if img.ndim == 2 else xw[:, t, None]
        term = img[:, xi[:, t]] * wt
        out = term if out is None else out + term
    across, out = out, None
    yi, yw = _area_taps(H, h)
    for t in range(yi.shape[1]):
        wt = yw[:, t, None] if img.ndim == 2 else yw[:, t, None, None]
        term = wt * across[yi[:, t]]
        out = term if out is None else out + term
    return out

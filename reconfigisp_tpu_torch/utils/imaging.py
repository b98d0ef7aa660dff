"""Image and array housekeeping.

Counterpart of reconfigisp_tpu/utils/imaging.py (reference
codes/utils/util.py:59-139): experiment-dir archiving, sensor-state packing
and float -> uint8 BGR conversion, numpy only; and the OnePlus dataset's
Bayer-aware resize (reference oneplus_rggb2obj_dataset.py:109-147), through
cv2.
"""

from __future__ import annotations

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
    with cv2's INTER_AREA, then re-interleaving them, which keeps the CFA
    structure (reference oneplus_rggb2obj_dataset.py:109-147: per-channel
    resize to 1024 + zero padding).  Returns a (target, target, 1) mosaic,
    zero-padded below and right where the aspect ratio is not 1; with
    return_extent also the (th, tw) extent of the content, so callers can
    place the padding band (the reference centres it, :118-119)."""
    import cv2
    h, w = mosaic.shape[:2]
    m = mosaic[..., 0] if mosaic.ndim == 3 else mosaic
    scale = target / max(h, w)
    th = int(round(h * scale / 2)) * 2
    tw = int(round(w * scale / 2)) * 2
    planes = [m[0::2, 0::2], m[0::2, 1::2], m[1::2, 0::2], m[1::2, 1::2]]
    small = [cv2.resize(p, (tw // 2, th // 2), interpolation=cv2.INTER_AREA)
             for p in planes]
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

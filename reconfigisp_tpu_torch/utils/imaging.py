"""Image and array housekeeping.

Counterpart of reconfigisp_tpu/utils/imaging.py (reference
codes/utils/util.py:59-139): experiment-dir archiving, sensor-state packing
and float -> uint8 BGR conversion; numpy only.  The Bayer-aware resize of
the OnePlus dataset comes with the YOLO slice (ROADMAP item 7).
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

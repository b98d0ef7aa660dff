"""Offline preprocessing: raw sensor dumps -> training pair folders.

Counterpart of reconfigisp_tpu/data/preprocessing.py, writing byte-equal
files: the port's data/dng.py, native/rawproc.py (built at first use; a
failed build raises), data/backends.PackedPairWriter and
data/datasets.SyntheticRawDataset take the JAX package's places.
Re-design of reference codes/data/preprocessing/
generate_rggb2bgr_imgs_SID_Sony.py:32-110 and
generate_rggb2bgr_imgs_S7ISP_percentage.py:37-106.  The reference decodes
ARW/DNG with rawpy (not available here); this module ingests uint16 .npy
mosaics (or any array loadable by numpy), applies black-level subtraction and
exposure-ratio scaling through the native rawproc library, slices aligned
patches, and writes the noisy/gt pair-folder layout that
RawPairFolderDataset consumes.  `synthesize_pair_folder` generates the same
layout from procedural scenes for hermetic end-to-end runs.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from reconfigisp_tpu_torch.native import rawproc
from reconfigisp_tpu_torch.utils import png


def grbg_to_rggb(mosaic: np.ndarray) -> np.ndarray:
    """Crop one column so a GRBG mosaic becomes RGGB
    (reference generate...S7ISP_percentage.py:52-62)."""
    return mosaic[:, 1:-1]


def _load_raw(path: str):
    """-> (uint16 mosaic, dng-meta-or-None).  .npy loads directly; .dng/.tiff
    goes through the pure-python TIFF-EP reader (data/dng.py — the rawpy
    replacement, reference generate...SID_Sony.py:44-50)."""
    if path.lower().endswith((".dng", ".tif", ".tiff")):
        from reconfigisp_tpu_torch.data import dng
        return dng.read_dng(path)
    return np.load(path), None


def process_raw_pairs(raw_paths, gt_paths, out_root: str, *,
                      black: Optional[float] = None,
                      white: Optional[float] = None, ratio=1.0,
                      patch: Optional[int] = 256,
                      stride: Optional[int] = None,
                      packed: bool = False) -> int:
    """Normalize raws, cut aligned patches, write pair folders or a packed
    record file (data/backends.py).

    raw: (H, W) uint16 mosaic .npy, or a DNG/TIFF-EP camera file (decoded
    by data/dng.py); gt: .npy/.png image, or a DNG whose postprocessed sRGB
    becomes the ground truth (the role rawpy.postprocess plays at reference
    generate...SID_Sony.py:60-66).  black/white default to the DNG's
    BlackLevel/WhiteLevel tags and MUST be given for .npy raws.
    `ratio` is the exposure-ratio scale applied to each raw — a scalar, or
    one value per pair for per-pair exposure handling (the reference bakes
    gt_exposure/in_exposure into its offline 'ratio' dumps,
    generate...SID_Sony.py:50-56).  Returns the number of patches written
    (reference writes 256px patch dumps + an index, :101-109)."""
    stride = stride or patch
    ratios = (list(ratio) if hasattr(ratio, "__len__")
              else [float(ratio)] * len(list(raw_paths)))
    writer = None
    if packed:
        from reconfigisp_tpu_torch.data.backends import PackedPairWriter
        writer = PackedPairWriter(out_root, resolution=patch)
    else:
        os.makedirs(os.path.join(out_root, "noisy"), exist_ok=True)
        os.makedirs(os.path.join(out_root, "gt"), exist_ok=True)

    def emit(name, mosaic, gt):
        if writer is not None:
            writer.add_pair(f"noisy/{name}", mosaic.astype(np.float32),
                            f"gt/{name}", gt.astype(np.float32))
        else:
            _dump(out_root, name, mosaic, gt)

    count = 0
    for (raw_p, gt_p, r) in zip(raw_paths, gt_paths, ratios):
        raw, meta = _load_raw(raw_p)
        b = black if black is not None else (
            meta["black_level"] if meta else None)
        w_ = white if white is not None else (
            meta["white_level"] if meta else None)
        if b is None or w_ is None:
            raise ValueError(f"{raw_p}: black/white levels required for "
                             ".npy raws (DNGs carry them in metadata)")
        mosaic = rawproc.normalize_u16(raw, b, w_, r)
        if gt_p.lower().endswith((".dng", ".tif", ".tiff")):
            from reconfigisp_tpu_torch.data import dng
            gt_mosaic, gt_meta = dng.read_dng(gt_p)
            gt = dng.postprocess(gt_mosaic, gt_meta)
        else:
            gt = np.load(gt_p) if gt_p.endswith(".npy") else png.read(gt_p)
        if gt.dtype == np.uint8:
            gt = gt.astype(np.float32) / 255.0
        name = os.path.splitext(os.path.basename(raw_p))[0]
        if patch is None:
            emit(name, mosaic, gt)
            count += 1
            continue
        h, w = mosaic.shape[:2]
        for y0 in range(0, h - patch + 1, stride):
            for x0 in range(0, w - patch + 1, stride):
                y0a, x0a = y0 & ~1, x0 & ~1
                emit(f"{name}_{y0a}_{x0a}",
                     mosaic[y0a:y0a + patch, x0a:x0a + patch],
                     gt[y0a:y0a + patch, x0a:x0a + patch])
                count += 1
    if writer is not None:
        writer.close()
    return count


def _dump(root, name, mosaic, gt):
    np.save(os.path.join(root, "noisy", name + ".npy"),
            mosaic.astype(np.float32))
    np.save(os.path.join(root, "gt", name + ".npy"), gt.astype(np.float32))


def synthesize_pair_folder(out_root: str, n: int = 16, size: int = 64,
                           seed: int = 0) -> int:
    """Write a synthetic pair folder (hermetic stand-in for SID/S7 dumps)."""
    from reconfigisp_tpu_torch.data.datasets import SyntheticRawDataset
    ds = SyntheticRawDataset(n=n, size=size, seed=seed)
    os.makedirs(os.path.join(out_root, "noisy"), exist_ok=True)
    os.makedirs(os.path.join(out_root, "gt"), exist_ok=True)
    for i in range(n):
        s = ds[i]
        np.save(os.path.join(out_root, "noisy", f"{i:05d}.npy"),
                s["noisy"][..., 0])
        np.save(os.path.join(out_root, "gt", f"{i:05d}.npy"), s["gt"])
    return n

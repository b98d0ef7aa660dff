"""Datasets: raw Bayer (noisy) -> sRGB ground truth.

Counterpart of reconfigisp_tpu/data/datasets.py, kept as its own copy
(reference codes/data/sid_sony_ratio_rggb2bgr_dataset.py:20-139,
s7isp_rggb2bgr_dataset.py:20-129).  Samples are numpy, and bit-identical to
the JAX package's for the same options, index and access count: every draw
of the numpy generators is made in the same order, with the same seeds and
casts.  The detection datasets (SyntheticDetectionDataset,
OnePlusDetectionDataset, reference oneplus_rggb2obj_dataset.py:23-265)
carry YOLO labels in place of the GT.

Conventions (the reference's):
  * noisy input: single-channel RGGB mosaic, normalized to [0, 1] by the
    sensor white level (16383 for 14-bit SID; 1023 for 10-bit S7/OnePlus);
  * GT: BGR in [0, 1];
  * random crops are RGGB-aligned: offsets snapped to even indices
    (sid...dataset.py:119-126).
"""

from __future__ import annotations

import collections
import os
import threading
from typing import Optional

import numpy as np
import torch

from reconfigisp_tpu_torch.data.backends import META_FILE, open_backend
from reconfigisp_tpu_torch.utils import png


def _crop_rng(seed: int, idx: int, access: int, is_train: bool):
    """Crop rng mixing a per-image access counter, so an image draws a fresh
    crop at every access (the reference draws per access,
    sid...dataset.py:121-124); eval crops stay fixed per index."""
    return np.random.default_rng((seed, idx, access if is_train else 0))


class _AccessCounter:
    """Per-image access counts for the crop rng.

    create_search_loaders hands one dataset to the train- and val-half
    prefetch threads, whose interleaving varies from run to run; counting
    per image index makes the k-th crop of image `idx` the same in every run
    with the same seed (the two halves touch disjoint indices)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: dict = collections.defaultdict(int)
        self._base = 0

    def set_base(self, n: int) -> None:
        with self._lock:
            self._base = int(n)

    def next_for(self, idx: int) -> int:
        with self._lock:
            n = self._counts[idx]
            self._counts[idx] = n + 1
            return self._base + n


def set_access_base(dataset, n: int) -> None:
    """Start `dataset`'s crop-access counters at n.

    The counters live in memory, so a resumed run would replay the crops of
    the run before it.  Resumed trainers call this with an upper bound on
    any access count already drawn: steps x batch, plus the val probe's
    draws (search/trainer._probe_access_slack).  No-op for datasets without
    crop counters."""
    acc = getattr(dataset, "_access", None)
    if acc is not None:
        acc.set_base(int(n))


class SyntheticRawDataset:
    """Procedural raw->sRGB pairs: piecewise-smooth BGR scenes are mosaicked
    (RGGB), gained down and noised to form the raw input; the clean scene is
    the ground truth.  Deterministic per (seed, index)."""

    def __init__(self, n: int = 64, size: int = 64, noise_std: float = 0.03,
                 gain: float = 0.5, seed: int = 0,
                 data_size: Optional[int] = None,
                 global_prob: float = 0.0):
        self.n = n
        self.size = size if data_size is None else data_size
        self.noise_std = noise_std
        self.gain = gain
        self.seed = seed
        # global_prob > 0 emits the local/global mixture of the local_global
        # loss: each sample carries glb_flag, 0 for a random crop of a
        # 2x-size scene, 1 for the whole scene 2x-downsampled
        self.global_prob = global_prob

    def __len__(self):
        return self.n

    def _scene(self, rng, s):
        yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / s
        base = np.stack([
            0.2 + 0.6 * (a * yy + b * xx) % 1.0
            for a, b in rng.uniform(0.3, 1.7, (3, 2))], axis=-1)
        for _ in range(4):  # random soft boxes
            y0, x0 = rng.integers(0, s // 2, 2)
            h, w = rng.integers(s // 8, s // 2, 2)
            color = rng.uniform(0.1, 0.9, 3)
            base[y0:y0 + h, x0:x0 + w] = 0.5 * base[y0:y0 + h, x0:x0 + w] + 0.5 * color
        return np.clip(base, 0.0, 1.0).astype(np.float32)

    @staticmethod
    def mosaic_rggb(bgr: np.ndarray) -> np.ndarray:
        """BGR (H,W,3) -> RGGB mosaic (H,W,1)."""
        h, w, _ = bgr.shape
        m = np.zeros((h, w), np.float32)
        m[0::2, 0::2] = bgr[0::2, 0::2, 2]  # R
        m[0::2, 1::2] = bgr[0::2, 1::2, 1]  # G
        m[1::2, 0::2] = bgr[1::2, 0::2, 1]  # G
        m[1::2, 1::2] = bgr[1::2, 1::2, 0]  # B
        return m[..., None]

    def __getitem__(self, idx: int) -> dict:
        rng = np.random.default_rng(self.seed * 100003 + idx)
        out = {}
        if self.global_prob > 0:
            s = self.size
            big = self._scene(rng, 2 * s)
            if rng.random() < self.global_prob:
                gt = 0.25 * (big[0::2, 0::2] + big[0::2, 1::2]
                             + big[1::2, 0::2] + big[1::2, 1::2])
                out["glb_flag"] = np.float32(1.0)
            else:
                y0 = int(rng.integers(0, s // 2 + 1)) * 2
                x0 = int(rng.integers(0, s // 2 + 1)) * 2
                gt = big[y0:y0 + s, x0:x0 + s]
                out["glb_flag"] = np.float32(0.0)
            gt = np.ascontiguousarray(gt, np.float32)
        else:
            gt = self._scene(rng, self.size)
        mosaic = self.mosaic_rggb(gt)
        noisy = mosaic * self.gain + rng.normal(
            0, self.noise_std, mosaic.shape).astype(np.float32)
        out.update({"noisy": np.clip(noisy, 0.0, 1.0).astype(np.float32),
                    "gt": gt})
        return out


def _even_crop(rng, h: int, w: int, s: int):
    """RGGB-aligned top-left corner of an s x s crop of an h x w frame."""
    y0 = int(rng.integers(0, max(h - s, 1) // 2 + 1)) * 2
    x0 = int(rng.integers(0, max(w - s, 1) // 2 + 1)) * 2
    return y0, x0


class RawPairFolderDataset:
    """Paired folder backend: <root>/noisy/<name>.npy and <root>/gt/<name>.npy
    (or .png, read by utils/png).  npy raws may be uint16 (divided by `white_level`) or
    float32 in [0,1]; pngs are divided by 255.

    data_size crops RGGB-aligned random patches (reference
    sid...dataset.py:119-126), fixed per index at eval; None returns full
    frames."""

    def __init__(self, root: str, data_size: Optional[int] = None,
                 white_level: float = 1023.0, seed: int = 0,
                 is_train: bool = True):
        self.root = root
        self.data_size = data_size
        self.white_level = white_level
        self.is_train = is_train
        self.seed = seed
        self._access = _AccessCounter()
        noisy_dir = os.path.join(root, "noisy")
        self.names = sorted(
            os.path.splitext(f)[0] for f in os.listdir(noisy_dir))
        if not self.names:
            raise ValueError(f"no files under {noisy_dir}")

    def __len__(self):
        return len(self.names)

    def _load(self, sub: str, name: str) -> np.ndarray:
        for ext in (".npy", ".png"):
            p = os.path.join(self.root, sub, name + ext)
            if os.path.exists(p):
                if ext == ".npy":
                    arr = np.load(p)
                    if arr.dtype == np.uint16:
                        arr = arr.astype(np.float32) / self.white_level
                    return arr.astype(np.float32)
                return png.read(p).astype(np.float32) / 255.0
        raise FileNotFoundError(f"{name} under {self.root}/{sub}")

    def __getitem__(self, idx: int) -> dict:
        name = self.names[idx]
        noisy = self._load("noisy", name)
        gt = self._load("gt", name)
        if noisy.ndim == 2:
            noisy = noisy[..., None]
        if self.data_size:
            s = self.data_size
            rng = _crop_rng(self.seed, idx,
                            self._access.next_for(idx), self.is_train)
            y0, x0 = _even_crop(rng, *noisy.shape[:2], s)
            noisy = noisy[y0:y0 + s, x0:x0 + s]
            gt = gt[y0:y0 + s, x0:x0 + s]
        return {"noisy": noisy, "gt": gt}


class SyntheticPlantedDataset(SyntheticRawDataset):
    """Planted-pipeline workload: the GT is a KNOWN ISP applied to the clean
    mosaic, so a correct search must recover its denoise, demosaic, WB and
    gamma choices.

    Per sample:
      scene S (linear BGR) -> camera raw = mosaic(S * cast) + shot/read noise
      GT = gamma_{1/2.2}( wb_{cast^-1}( malvar( mosaic(S * cast) ) ) )
    The GT is computed with the port's own ops on the host CPU (an explicit
    CPU device, inside the loader's thread: no CUDA there), so the planted
    architecture Bayer_01 -> Demosaic_03 (Malvar) -> sRGB_11 (wbmanual) ->
    sRGB_01 (gamma) reproduces it up to the denoise error.  No exposure gain
    is planted (gain 1).
    """

    # BGR channel gains the 'camera' applies (tungsten-ish cast)
    CAST = (0.8, 1.0, 0.6)
    # planted op params01: wbmanual gains = cast^-1 / 5; gamma exp 1/2.2
    WB_PARAMS01 = tuple(1.0 / c / 5.0 for c in CAST)
    GAMMA_PARAM01 = 0.5 - float(np.log(2.2) / (2.0 * np.log(3.0)))

    def __init__(self, n: int = 64, size: int = 64, shot: float = 0.08,
                 read: float = 0.02, seed: int = 0,
                 data_size: Optional[int] = None):
        super().__init__(n=n, size=size, noise_std=read, gain=1.0,
                         seed=seed, data_size=data_size)
        self.shot = shot
        self._gt_cache: dict = {}

    @torch.no_grad()
    def _planted(self, clean_mosaic: np.ndarray) -> np.ndarray:
        """The planted GT pipeline on the clean mosaic, on the host CPU."""
        from reconfigisp_tpu_torch.ops import color, demosaic as dm
        cpu = torch.device("cpu")
        m = torch.from_numpy(clean_mosaic[None]).to(cpu)
        y = dm.demosaic_malvar(m, None, None)
        wb = torch.tensor([self.WB_PARAMS01], dtype=torch.float32, device=cpu)
        y = color.wb_manual(y, wb)
        g = torch.tensor([[self.GAMMA_PARAM01]], dtype=torch.float32,
                         device=cpu)
        return color.gamma(y, g)[0].numpy()

    def __getitem__(self, idx: int) -> dict:
        if idx in self._gt_cache:
            clean, gt = self._gt_cache[idx]
        else:
            rng = np.random.default_rng(self.seed * 100003 + idx)
            scene = self._scene(rng, self.size)
            cast = np.asarray(self.CAST, np.float32)[None, None, :]
            clean = self.mosaic_rggb(np.clip(scene * cast, 0.0, 1.0))
            gt = np.clip(self._planted(clean), 0.0, 1.0).astype(np.float32)
            self._gt_cache[idx] = (clean, gt)
        nrng = np.random.default_rng(self.seed * 900007 + idx)
        sigma = np.sqrt((self.shot ** 2) * clean + self.noise_std ** 2)
        noisy = clean + nrng.normal(0, 1, clean.shape).astype(np.float32) * sigma
        return {"noisy": np.clip(noisy, 0.0, 1.0).astype(np.float32),
                "gt": gt}


class SyntheticDetectionDataset(SyntheticRawDataset):
    """Raw Bayer -> detection targets: scenes hold bright rectangles whose
    boxes are the labels (the hermetic analog of the OnePlus labelme-JSON
    dataset, reference oneplus_rggb2obj_dataset.py:160-194).

    Labels: (max_boxes, 6) rows [valid, cls, cx, cy, w, h] normalized, the
    YOLO target layout (a fixed max_boxes in place of the reference's
    variable-length collate, oneplus...py:207-229)."""

    def __init__(self, n: int = 64, size: int = 64, max_boxes: int = 8,
                 **kw):
        super().__init__(n=n, size=size, **kw)
        self.max_boxes = max_boxes

    def __getitem__(self, idx: int) -> dict:
        rng = np.random.default_rng(self.seed * 100003 + idx)
        s = self.size
        gt = self._scene(rng, s) * 0.4
        labels = np.zeros((self.max_boxes, 6), np.float32)
        n_obj = int(rng.integers(1, min(self.max_boxes, 4) + 1))
        for k in range(n_obj):
            h, w = rng.integers(s // 8, s // 3, 2)
            y0 = int(rng.integers(0, s - h))
            x0 = int(rng.integers(0, s - w))
            gt[y0:y0 + h, x0:x0 + w] = rng.uniform(0.7, 1.0, 3)
            labels[k] = [1.0, 0.0, (x0 + w / 2) / s, (y0 + h / 2) / s,
                         w / s, h / s]
        gt = np.clip(gt, 0, 1).astype(np.float32)
        mosaic = self.mosaic_rggb(gt)
        noisy = mosaic * self.gain + rng.normal(
            0, self.noise_std, mosaic.shape).astype(np.float32)
        return {"noisy": np.clip(noisy, 0, 1).astype(np.float32),
                "gt": gt, "label": labels}


class PairRecordDataset:
    """meta_info-indexed raw/GT pair dataset over any storage backend.

    Counterpart of the JAX PairRecordDataset (reference
    sid_sony_ratio_rggb2bgr_dataset.py:20-139): keys come from
    meta_info.pkl's keys_noisy|keys_ratio / keys_gt lists; records are read
    through data/backends.py (packed memmap, lmdb, or files); train crops
    are RGGB-aligned; uint16 raws divide by `white_level` (16383 SID 14-bit,
    1023 S7 10-bit), uint8 GTs by 255, uint16 GTs by 65535.

    Exposure selection (sid...py:50-58): keep only pairs whose noisy key
    contains `expo_in` and whose GT key contains `expo_gt`.  A crop is cut
    from the stored record before its conversion to float, which gives the
    values of converting first and cropping after.
    """

    def __init__(self, root: str, data_size: Optional[int] = None,
                 white_level: float = 16383.0, seed: int = 0,
                 is_train: bool = True, data_type: Optional[str] = None,
                 expo_in: Optional[str] = None,
                 expo_gt: Optional[str] = None):
        self.reader, meta = open_backend(root, data_type)
        if meta is None:
            raise ValueError(f"{root} has no meta_info.pkl index")
        self.keys_noisy = list(meta.get("keys_ratio")
                               or meta.get("keys_noisy"))
        self.keys_gt = list(meta["keys_gt"])
        if expo_in is not None or expo_gt is not None:
            pairs = [(kn, kg) for kn, kg
                     in zip(self.keys_noisy, self.keys_gt)
                     if (expo_in or "") in kn and (expo_gt or "") in kg]
            self.keys_noisy = [p[0] for p in pairs]
            self.keys_gt = [p[1] for p in pairs]
        if not self.keys_noisy:
            raise ValueError(f"no pairs selected from {root}")
        self.data_size = data_size
        self.white_level = white_level
        self.is_train = is_train
        self.seed = seed
        self._access = _AccessCounter()

    def __len__(self):
        return len(self.keys_noisy)

    @staticmethod
    def _to01(arr: np.ndarray, white: float) -> np.ndarray:
        if arr.dtype == np.uint8:
            return arr.astype(np.float32) / 255.0
        if arr.dtype in (np.uint16, np.int16):
            return arr.astype(np.float32) / white
        return arr.astype(np.float32)

    def __getitem__(self, idx: int) -> dict:
        noisy = self.reader.read(self.keys_noisy[idx])
        gt = self.reader.read(self.keys_gt[idx])
        if noisy.ndim == 2:
            noisy = noisy[..., None]
        if self.data_size and self.is_train:
            s = self.data_size
            rng = _crop_rng(self.seed, idx,
                            self._access.next_for(idx), True)
            y0, x0 = _even_crop(rng, *noisy.shape[:2], s)
            noisy = noisy[y0:y0 + s, x0:x0 + s]
            gt = gt[y0:y0 + s, x0:x0 + s]
        # GT records are sRGB: uint8/255 or uint16/65535 (a 16-bit GT is
        # full-range, not sensor-white scaled)
        return {"noisy": np.ascontiguousarray(
                    self._to01(noisy, self.white_level)),
                "gt": np.ascontiguousarray(self._to01(gt, 65535.0))}


# COCO class ids (reference oneplus_rggb2obj_dataset.py:46)
ONEPLUS_CLASSES = {"person": 0, "car": 2, "bus": 5}


class OnePlusDetectionDataset:
    """Raw OnePlus mosaics + labelme-JSON boxes -> YOLO training samples.

    Counterpart of OnePlusRggb2ObjDataset (reference
    oneplus_rggb2obj_dataset.py:23-233): a uint16 PNG mosaic (10-bit) and a
    sibling .json per frame; Bayer-aware per-plane resize to `desired`^2,
    the content band centred between zero rows (:109-147,
    utils/imaging.bayer_aware_resize); RGGB-aligned random crops re-drawn up
    to `max_crop` times until a box survives the IoU >= 0.5 visibility
    filter (:153-194), else the best crop drawn.  Labels are a fixed
    (max_boxes, 6) array [valid, cls, cx, cy, w, h] normalized to the crop.
    Eval tiles the padded frame: offsets evenly spaced over [0, d - s],
    even-snapped, the last flush with the far edge, and __len__ enumerates
    image x tile; with data_size == desired one tile is the whole frame.
    """

    def __init__(self, root: str, data_size: int = 256, *,
                 desired: int = 1024, max_crop: int = 4, max_boxes: int = 16,
                 white_level: float = 1023.0, seed: int = 0,
                 is_train: bool = True,
                 classes: Optional[dict] = None):
        import glob
        self.root = root
        self.img_files = sorted(glob.glob(os.path.join(root, "*.png")))
        self.json_files = sorted(glob.glob(os.path.join(root, "*.json")))
        if len(self.img_files) != len(self.json_files) or not self.img_files:
            raise ValueError(
                f"{root}: need matching *.png / *.json files "
                f"({len(self.img_files)} vs {len(self.json_files)})")
        self.data_size = data_size
        self.desired = desired
        self.max_crop = max_crop
        self.max_boxes = max_boxes
        self.white_level = white_level
        self.seed = seed
        self.is_train = is_train
        self.classes = classes or ONEPLUS_CLASSES
        self._access = _AccessCounter()
        if not is_train and data_size < desired:
            k = int(np.ceil(desired / data_size)) + 1
            offs = sorted({int(o) // 2 * 2 for o in
                           np.linspace(0, desired - data_size, k)})
            self._eval_tiles = [(r, c) for r in offs for c in offs]
        else:
            self._eval_tiles = [(0, 0)]

    def __len__(self):
        n_tiles = 1 if self.is_train else len(self._eval_tiles)
        return len(self.img_files) * n_tiles

    def _load_resized(self, idx: int):
        """-> (mosaic01 (D, D, 1), ratio_h, ratio_w, top_pad)."""
        from reconfigisp_tpu_torch.utils.imaging import bayer_aware_resize
        img = png.read(self.img_files[idx])
        oh, ow = img.shape[:2]
        mosaic01 = img.astype(np.float32) / self.white_level
        resized, (th, tw) = bayer_aware_resize(
            mosaic01, self.desired, return_extent=True)
        top = (self.desired - th) // 2 // 2 * 2
        if top:  # centre the content band (the reference pads top+bottom)
            shifted = np.zeros_like(resized)
            shifted[top:top + th] = resized[:th]
            resized = shifted
        return resized, th / oh, tw / ow, top

    def _boxes(self, idx: int):
        import json
        with open(self.json_files[idx]) as f:
            label = json.load(f)
        out = []
        for shape in label.get("shapes", []):
            if shape.get("label") not in self.classes:
                continue
            pts = np.asarray(shape["points"], np.float64)
            out.append((self.classes[shape["label"]],
                        pts[:, 0].min(), pts[:, 1].min(),
                        pts[:, 0].max(), pts[:, 1].max()))
        return out

    def __getitem__(self, idx: int) -> dict:
        n_tiles = 1 if self.is_train else len(self._eval_tiles)
        img_idx, tile_idx = idx // n_tiles, idx % n_tiles
        mosaic, rh, rw, top = self._load_resized(img_idx)
        raw_boxes = self._boxes(img_idx)
        s = self.data_size
        rng = _crop_rng(self.seed, img_idx,
                        self._access.next_for(idx), self.is_train)
        d = self.desired

        # the best crop over the draws: most surviving boxes, ties (the
        # all-failed case among them) broken by the highest box visibility
        best = (mosaic[:s, :s], np.zeros((self.max_boxes, 6), np.float32))
        best_score = (-1, -1.0)
        for _ in range(self.max_crop if self.is_train else 1):
            if self.is_train:
                r0 = int(rng.integers(min(top, d - s), d - s + 1)) // 2 * 2
                c0 = int(rng.integers(0, d - s + 1)) // 2 * 2
            else:
                r0, c0 = self._eval_tiles[tile_idx]
            labels = np.zeros((self.max_boxes, 6), np.float32)
            k = 0
            max_vis = 0.0
            for cls, x0, y0, x1, y1 in raw_boxes:
                # frame coords -> resized+padded coords -> crop coords
                xa, xb = x0 * rw - c0, x1 * rw - c0
                ya, yb = y0 * rh + top - r0, y1 * rh + top - r0
                xav, xbv = np.clip([xa, xb], 0, s - 1)
                yav, ybv = np.clip([ya, yb], 0, s - 1)
                area = (xb - xa) * (yb - ya)
                vis = (xbv - xav) * (ybv - yav)
                if area <= 0:
                    continue
                max_vis = max(max_vis, float(vis / area))
                if vis / area < 0.5:  # IoU >= 0.5 filter
                    continue
                if k < self.max_boxes:
                    labels[k] = [1.0, float(cls),
                                 (xav + xbv) / 2 / s, (yav + ybv) / 2 / s,
                                 (xbv - xav) / s, (ybv - yav) / s]
                    k += 1
            crop = mosaic[r0:r0 + s, c0:c0 + s]
            if (k, max_vis) > best_score:
                best = (crop, labels)
                best_score = (k, max_vis)
            if k > 0:
                break
        crop, labels = best
        return {"noisy": np.ascontiguousarray(crop, np.float32),
                "label": labels}


def create_dataset(dataset_opt: dict):
    """Factory keyed on `mode` (reference codes/data/__init__.py:33-53)."""
    mode = dataset_opt.get("mode", "synthetic")
    is_train = dataset_opt.get("is_train", True)
    if is_train is None:
        is_train = True
    if mode in ("synthetic", "Synthetic"):
        return SyntheticRawDataset(
            n=dataset_opt.get("n", 64) or 64,
            size=dataset_opt.get("data_size", 64) or 64,
            noise_std=dataset_opt.get("noise_std", 0.03) or 0.03,
            seed=dataset_opt.get("seed", 0) or 0,
            global_prob=dataset_opt.get("global_prob", 0.0) or 0.0)
    if mode in ("synthetic_planted", "SyntheticPlanted"):
        return SyntheticPlantedDataset(
            n=dataset_opt.get("n", 64) or 64,
            size=dataset_opt.get("data_size", 64) or 64,
            shot=dataset_opt.get("noise_shot", 0.08) or 0.08,
            read=dataset_opt.get("noise_read", 0.02) or 0.02,
            seed=dataset_opt.get("seed", 0) or 0)
    if mode in ("synthetic_yolo", "SyntheticYolo"):
        # frame_size lets test configs emit frames larger than data_size:
        # the split-mode regime (merged frame != configured crop size)
        return SyntheticDetectionDataset(
            n=dataset_opt.get("n", 64) or 64,
            size=(dataset_opt.get("frame_size")
                  or dataset_opt.get("data_size", 64) or 64),
            seed=dataset_opt.get("seed", 0) or 0)
    seed = dataset_opt.get("seed", 0) or 0
    if mode.startswith("OnePlus"):
        desired = dataset_opt.get("desired_size", 1024) or 1024
        # `data_size: ~` means the whole image in the reference's test ymls
        # (options/test/yolo_test.yml:17): for OnePlus the full resized
        # frame (`desired`), not the 256 training default
        return OnePlusDetectionDataset(
            dataset_opt["dataroot"],
            dataset_opt.get("data_size") or (256 if is_train else desired),
            desired=desired,
            max_crop=dataset_opt.get("max_crop", 4) or 4,
            max_boxes=dataset_opt.get("max_boxes", 16) or 16,
            seed=seed, is_train=is_train)
    if mode.startswith(("SID", "S7ISP", "Folder")):
        white = 16383.0 if mode.startswith("SID") else 1023.0
        root = dataset_opt["dataroot"]
        if os.path.exists(os.path.join(root, META_FILE)):
            return PairRecordDataset(
                root, dataset_opt.get("data_size"), white_level=white,
                seed=seed, is_train=is_train,
                data_type=dataset_opt.get("data_type"),
                expo_in=dataset_opt.get("sid_expo_in"),
                expo_gt=dataset_opt.get("sid_expo_gt"))
        return RawPairFolderDataset(
            root, dataset_opt.get("data_size"), white_level=white,
            seed=seed, is_train=is_train)
    raise ValueError(f"unknown dataset mode {mode!r}")

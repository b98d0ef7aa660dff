"""Real-scale rehearsal: the shipped SID, S7 and OnePlus configs end to end
at the reference's data scale, on fabricated frames.

Counterpart of the repo's tools/rehearse_real_scale.py, on the GPU unless
`--device cpu` is given.  Each config runs as written, except its dataroot
(the fixtures), `dist` (one card), the module bank
(experiments/proxies/default.ckpt of the checkout, which the port reads and
never writes) and, for detection, the darknet file the leg writes:

  SID leg     — 1424x2128 14-bit RGGB frames (reference
                generate_rggb2bgr_imgs_SID_Sony.py:50), written as DNGs by
                data/dng.py and ingested by data/preprocessing.py, then
                configs/SID_search.yaml (3-step / 15-op native search, 48px
                crops) -> configs/SID_isp.yaml (192px fixed training) ->
                configs/SID_test.yaml (512/480 tiled full-frame test with
                exposure-pair selection).
  S7 leg      — 3024x4032 10-bit GRBG frames (reference
                generate_rggb2bgr_imgs_S7ISP_percentage.py:37-62), cropped
                to RGGB by preprocessing, then configs/S7ISP_search_ft.yaml
                (darts_ft search with online proxy tuning) ->
                configs/S7ISP_isp.yaml (384px fixed training) ->
                configs/S7ISP_test.yaml (512/480 tiled test).
  OnePlus leg — 3000x4000 10-bit mosaics as 16-bit PNGs with labelme JSONs
                (reference oneplus_rggb2obj layout) and an 80-class YOLOv3
                darknet file, its criterion pretrained on clean letterboxed
                views of the scenes, then configs/yolo_search.yaml (256px
                darts_yolo search) -> configs/yolo_isp.yaml (512px fixed
                training) -> configs/yolo_test.yaml (1024px detection test).

The search phases are smoke-sized (--iters; the detection search a quarter
of it, at least 4); the fixed-pipeline phases run a learning budget
(--learn-iters), so the results carry the loss's fall and the test PSNR or
mAP.  Each phase records compile_s apart from steady_s_per_iter, and the
reference's iteration budget projected at the steady rate.  Scenes are
upsampled with torch's bicubic interpolation, SID's GT is written as .npy,
the OnePlus PNGs by utils/png and the letterbox by utils/imaging's area
resize, so no cv2 is needed.  Writes <out>/results.json with the device's
name and power limit; the fixtures go under --root, the runs' experiment
and result trees under <out>.

Usage:  python -m reconfigisp_tpu_torch.tools.rehearse_real_scale
        [--root DIR] [--iters N] [--learn-iters N] [--legs sid,s7,yolo]
        [--phases search,isp,test] [--out DIR] [--device cpu]
        [--sid-size HxW] [--s7-size HxW] [--oneplus-size HxW]
        [--criterion-iters N] [--yolo-search-iters N]
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import io
import json
import math
import os
import time

import numpy as np
import torch
import torch.nn.functional as F
import yaml

from reconfigisp_tpu_torch import config
from reconfigisp_tpu_torch.device import resolve_device
from reconfigisp_tpu_torch.search.trainer import run_training
from reconfigisp_tpu_torch.tools import CONFIGS, REPO, device_record

OUT_DIR = os.path.join("experiments", "rehearsal_torch")
BANK = REPO / "experiments" / "proxies" / "default.ckpt"
SID_SIZE = (1424, 2128)
S7_SIZE = (3024, 4032)
ONEPLUS_SIZE = (3000, 4000)
# the detection configs' frozen evaluator and the OnePlus dataset's
# letterbox (its desired_size, 1024 by default)
DETECTOR = "yolov3"
DESIRED = 1024

# reference iteration budgets (options/train/*.yml): the projection says
# how long the reference's whole budget takes at the measured steady rate
REF_BUDGETS = {
    ("sid", "search"): 200000,    # SID_search.yml:50
    ("sid", "isp"): 80000,        # SID_isp.yml:42
    ("s7", "search_ft"): 100000,  # S7ISP_search.yml:46
    ("s7", "isp"): 80000,         # S7ISP_isp.yml:42
    ("yolo", "search"): 40000,    # yolo_search.yml:42
    ("yolo", "isp"): 8000,        # yolo_isp.yml:40
}


def log(*a):
    print("[rehearsal]", *a, flush=True)


def _phase(summary: dict, iters: int, leg: str, phase: str) -> dict:
    """A training phase's record: the iteration count, first and final
    loss, compile time apart from the steady s/iter, and the projected
    wall-clock of the reference budget at the steady rate."""
    out = {"iters": iters}
    for k in ("architecture", "loss_first", "loss", "compile_s",
              "steady_s_per_iter", "loss_head_mean", "loss_tail_mean",
              "val_loss_head_mean", "val_loss_tail_mean",
              "alpha_top_minus_median", "alpha_gap_max",
              "probe_loss_start", "probe_loss_final",
              "val_psnr_start", "val_psnr_final", "steps_run"):
        if summary.get(k) is not None:
            out[k] = summary[k]
    budget = REF_BUDGETS.get((leg, phase))
    steady = summary.get("steady_s_per_iter")
    if budget and steady:
        out["ref_budget_iters"] = budget
        out["ref_budget_hours_at_steady"] = round(budget * steady / 3600, 2)
    return out


def _latest_ckpt(pattern: str) -> str:
    ckpts = glob.glob(pattern)
    if not ckpts:
        raise FileNotFoundError(f"no checkpoint matches {pattern}")
    return max(ckpts, key=lambda p: int(os.path.basename(p).split("_")[0]))


def _smooth_scene(rng, h, w):
    """Piecewise-smooth BGR scene at any aspect: low-resolution noise
    upsampled bicubically (on the host), then six blended rectangles."""
    low = rng.uniform(0.1, 0.9, (h // 64 + 2, w // 64 + 2, 3)).astype(
        np.float32)
    up = F.interpolate(torch.from_numpy(low).permute(2, 0, 1)[None],
                       size=(h, w), mode="bicubic", align_corners=False)
    img = up[0].permute(1, 2, 0).contiguous().numpy()
    for _ in range(6):
        y0, x0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
        hh, ww = rng.integers(h // 8, h // 2), rng.integers(w // 8, w // 2)
        img[y0:y0 + hh, x0:x0 + ww] = \
            0.5 * img[y0:y0 + hh, x0:x0 + ww] + 0.5 * rng.uniform(0.1, 0.9, 3)
    return np.clip(img, 0, 1)


def _mosaic(bgr):
    h, w, _ = bgr.shape
    m = np.zeros((h, w), np.float32)
    m[0::2, 0::2] = bgr[0::2, 0::2, 2]
    m[0::2, 1::2] = bgr[0::2, 1::2, 1]
    m[1::2, 0::2] = bgr[1::2, 0::2, 1]
    m[1::2, 1::2] = bgr[1::2, 1::2, 0]
    return m


def _fresh(opt):
    """A fresh run: an earlier rehearsal's experiment dir is archived, so
    its checkpoints cannot leak into this one."""
    opt["train"]["resume"] = False
    opt["use_tb_logger"] = False
    return opt


def _options(name: str, out: str, dataroot: str) -> dict:
    """A training config as written, rooted at `out`, its train set at
    `dataroot`, and the checkout's module bank where it names none (the
    JAX package's config.parse finds it under its working directory)."""
    opt = config.parse(str(CONFIGS / f"{name}.yaml"), is_train=True,
                       root=out)
    opt["datasets"]["train"]["dataroot"] = dataroot
    if not opt["path"].get("pretrain_proxies"):
        if not BANK.exists():
            raise FileNotFoundError(f"the module bank {BANK} is missing")
        opt["path"]["pretrain_proxies"] = str(BANK)
    return _fresh(opt)


def _test(name: str, out: str, root: str, dataroot: str, ckpt: str,
          device, edit=None) -> dict:
    """A test config as written, its test set at `dataroot`, the network
    `ckpt`, results under `out`, then `edit(options)` if given -> the test
    CLI's summary."""
    with open(CONFIGS / f"{name}.yaml") as f:
        topt = yaml.safe_load(f)
    topt["datasets"]["test"]["dataroot"] = dataroot
    topt["path"]["pretrain_model_G"] = ckpt
    if edit is not None:
        edit(topt)
    topt["path"]["root"] = os.path.abspath(out)
    tpath = os.path.join(root, f"{name}_rehearsal.yaml")
    with open(tpath, "w") as f:
        yaml.safe_dump(topt, f)
    return _run_test_cli(tpath, device)


# --------------------------------------------------------------- SID leg

def _sid_frame(scene, rng, ratio=100.0, black=512, white=16383):
    """A scene -> (short-exposure 14-bit RGGB raw, uint8 GT)."""
    clean = _mosaic(scene)
    short = clean / ratio + rng.normal(0, 0.002, clean.shape)
    raw_u16 = np.clip(short * (white - black) + black,
                      0, white).astype(np.uint16)
    return raw_u16, (scene * 255).astype(np.uint8)


def build_sid_fixtures(root, n_train=2, n_test=1, seed=0, size=SID_SIZE):
    """Fabricated SID: short-exposure DNG raws (1424x2128, 14-bit, black
    512) and GT .npy; the train pairs ingested from the DNGs into a pair
    folder by preprocessing, the test pairs into a packed set with
    exposure-tagged keys."""
    from reconfigisp_tpu_torch.data import dng, preprocessing
    from reconfigisp_tpu_torch.data.backends import PackedPairWriter

    H, W = size
    BLACK, WHITE = 512, 16383
    rng = np.random.default_rng(seed)
    raw_dir = os.path.join(root, "sid_raw")
    os.makedirs(raw_dir, exist_ok=True)

    def fabricate(i):
        raw_u16, gt_u8 = _sid_frame(_smooth_scene(rng, H, W), rng,
                                    black=BLACK, white=WHITE)
        rp = os.path.join(raw_dir, f"{i:05d}_0.1s_10s.dng")
        gp = os.path.join(raw_dir, f"{i:05d}_gt.npy")
        dng.write_dng(rp, raw_u16, black=BLACK, white=WHITE, bits=14)
        np.save(gp, gt_u8)
        return rp, gp

    train_pairs = [fabricate(i) for i in range(n_train)]
    train_root = os.path.join(root, "sid_train")
    n = preprocessing.process_raw_pairs(
        [p[0] for p in train_pairs], [p[1] for p in train_pairs],
        train_root, ratio=100.0, patch=None)
    log(f"SID train fixtures: {n} full frames at {H}x{W} (DNG ingress)")

    test_root = os.path.join(root, "sid_test")
    with PackedPairWriter(test_root, resolution=None) as w:
        for i in range(n_test):
            rp, gp = fabricate(100 + i)
            mosaic, meta = dng.read_dng(rp)
            m01 = (mosaic.astype(np.float32) - meta["black_level"]) / (
                meta["white_level"] - meta["black_level"]) * 100.0
            w.add_pair(f"noisy/{100 + i:05d}_0.1s", np.clip(m01, 0, 1),
                       f"gt/{100 + i:05d}_10s", np.load(gp))
    log(f"SID test fixtures: {n_test} packed frames with exposure keys")
    return train_root, test_root


def run_sid_leg(root, iters, learn_iters, phases=("search", "isp", "test"),
                *, out=OUT_DIR, device=None, size=SID_SIZE):
    train_root, test_root = build_sid_fixtures(root, size=size)
    res = {}

    if "search" in phases:
        opt = _options("SID_search", out, train_root)
        opt["dist"] = False       # one card
        s = run_training(opt, max_iters=iters, device=device)
        res["search"] = _phase(s, iters, "sid", "search")
        log(f"SID search ok: {res['search']}")

    if "isp" in phases:
        opt = _options("SID_isp", out, train_root)
        # The reference trains op hyperparameters only, its CNNs frozen at
        # an 800k-step Path-Restore checkpoint; the repo's bank is a far
        # cheaper stand-in whose frozen path_bayer caps the SID-regime
        # fixtures, so SID_isp trains the weights too, as the JAX
        # rehearsal does.
        opt["train"]["train_weights"] = True
        s = run_training(opt, max_iters=learn_iters, device=device)
        res["isp"] = _phase(s, learn_iters, "sid", "isp")
        log(f"SID isp ok: {res['isp']}")

    if "test" in phases:
        ckpt = _latest_ckpt(os.path.join(out, "experiments", "SID_isp",
                                         "models", "*_G.ckpt"))
        res["test"] = _test("SID_test", out, root, test_root, ckpt, device)
        log(f"SID tiled test ok: {res['test']}")
    return res


# --------------------------------------------------------------- S7-ISP leg

def _s7_frame(scene, rng, white=1023):
    """A scene -> (10-bit raw cropped from GRBG to RGGB, GT cropped alike).
    The GRBG frame shifts the CFA phase, not the image: the mosaic of a
    left-padded scene, so column x keeps scene pixel x but samples the
    (x+1)%2 phase (shifting the content would misregister raw and GT)."""
    from reconfigisp_tpu_torch.data import preprocessing
    grbg = _mosaic(np.concatenate([scene[:, :1], scene], axis=1))[:, 1:]
    noisy = grbg + rng.normal(0, 0.01, grbg.shape)
    u16 = np.clip(noisy * white, 0, white).astype(np.uint16)
    return preprocessing.grbg_to_rggb(u16), scene[:, 1:-1]


def build_s7_fixtures(root, n_train=2, n_test=1, seed=2, size=S7_SIZE):
    """Fabricated S7-ISP: 3024x4032 10-bit GRBG mosaics (Samsung S7 sensor
    scale), cropped to RGGB, written as full-frame folder pairs at white
    level 1023.  Kept where the test folder exists."""
    from reconfigisp_tpu_torch.data import preprocessing
    H, W = size
    WHITE = 1023
    rng = np.random.default_rng(seed)
    train_root = os.path.join(root, "s7_train")
    test_root = os.path.join(root, "s7_test")
    if os.path.exists(os.path.join(test_root, "noisy")):
        return train_root, test_root
    src = os.path.join(root, "s7_src")
    os.makedirs(src, exist_ok=True)
    raws, gts = [], []
    for i in range(n_train + n_test):
        rggb_u16, gt = _s7_frame(_smooth_scene(rng, H, W), rng, WHITE)
        rp = os.path.join(src, f"s7_{i}.npy")
        gp = os.path.join(src, f"s7_{i}_gt.npy")
        np.save(rp, rggb_u16)
        np.save(gp, gt.astype(np.float32))
        raws.append(rp)
        gts.append(gp)
    preprocessing.process_raw_pairs(
        raws[:n_train], gts[:n_train], train_root,
        black=0, white=WHITE, patch=None)
    preprocessing.process_raw_pairs(
        raws[n_train:], gts[n_train:], test_root,
        black=0, white=WHITE, patch=None)
    log(f"S7 fixtures: {n_train}+{n_test} GRBG->RGGB frames at "
        f"{H}x{rggb_u16.shape[1]}, white {WHITE}")
    return train_root, test_root


def run_s7_leg(root, iters, learn_iters, phases=("search", "isp", "test"),
               *, out=OUT_DIR, device=None, size=S7_SIZE):
    train_root, test_root = build_s7_fixtures(root, size=size)
    res = {}

    if "search" in phases:
        opt = _options("S7ISP_search_ft", out, train_root)
        opt["dist"] = False
        # tuning rounds several times inside the rehearsal's budget (the
        # reference re-tunes every 100 of 100k steps, darts_ft_model.py:206)
        opt["proxy_ft_params"]["ft_interval"] = max(2, min(50, iters // 2))
        opt["proxy_ft_params"]["ft_steps"] = 2
        s = run_training(opt, max_iters=iters, device=device)
        res["search_ft"] = _phase(s, iters, "s7", "search_ft")
        log(f"S7 darts_ft search ok: {res['search_ft']}")

    if "isp" in phases:
        opt = _options("S7ISP_isp", out, train_root)
        s = run_training(opt, max_iters=learn_iters, device=device)
        res["isp"] = _phase(s, learn_iters, "s7", "isp")
        log(f"S7 isp ok: {res['isp']}")

    if "test" in phases:
        ckpt = _latest_ckpt(os.path.join(out, "experiments", "S7ISP_isp",
                                         "models", "*_G.ckpt"))
        res["test"] = _test("S7ISP_test", out, root, test_root, ckpt, device)
        log(f"S7 tiled test ok: {res['test']}")
    return res


# ------------------------------------------------------------ OnePlus leg

def _letterbox(scene, desired):
    """The OnePlus dataset's geometry on a clean BGR scene
    (data/datasets.py, OnePlusDetectionDataset._load_resized): an
    aspect-preserving area resize into a `desired`-square canvas, the
    content band at an even `top`.  -> (canvas float32, (rh, rw, top)): a
    box maps as x * rw, y * rh + top, as the dataset's labels do."""
    from reconfigisp_tpu_torch.utils.imaging import area_resize
    h, w = scene.shape[:2]
    scale = desired / max(h, w)
    th = int(round(h * scale / 2)) * 2
    tw = int(round(w * scale / 2)) * 2
    top = (desired - th) // 2 // 2 * 2
    canvas = np.zeros((desired, desired, 3), np.float32)
    canvas[top:top + th, :tw] = area_resize(scene, (th, tw))
    return np.clip(canvas, 0, 1).astype(np.float32), (th / h, tw / w, top)


def _detector_blocks():
    from reconfigisp_tpu_torch.yolo import cfg as ycfg
    if DETECTOR == "yolov3":
        return ycfg.yolov3_blocks(num_classes=80)
    return ycfg.yolov3_tiny_test_blocks(num_classes=80)


def oneplus_frames(n=2, seed=0, size=ONEPLUS_SIZE):
    """The JAX tool's OnePlus draws: per frame a dimmed smooth scene with
    four bright "car" boxes of 300-900 px (scaled with a smaller `size`)
    -> [(scene, labelme shapes, 10-bit mosaic uint16)]."""
    H, W = size
    rng = np.random.default_rng(seed)
    side = min(H / ONEPLUS_SIZE[0], W / ONEPLUS_SIZE[1])
    lo, hi = int(300 * side), int(900 * side)
    frames = []
    for _ in range(n):
        scene = _smooth_scene(rng, H, W) * 0.35
        shapes = []
        for _ in range(4):
            hh, ww = rng.integers(lo, hi), rng.integers(lo, hi)
            y0 = int(rng.integers(0, H - hh))
            x0 = int(rng.integers(0, W - ww))
            scene[y0:y0 + hh, x0:x0 + ww] = rng.uniform(0.7, 1.0, 3)
            shapes.append({"label": "car",
                           "points": [[int(x0), int(y0)],
                                      [int(x0 + ww), int(y0 + hh)]]})
        mosaic = (np.clip(_mosaic(scene), 0, 1) * 1023).astype(np.uint16)
        frames.append((scene, shapes, mosaic))
    return frames


def build_oneplus_fixtures(root, n=2, seed=0, pretrain_iters=0, *,
                           size=ONEPLUS_SIZE, device=None):
    """Fabricated OnePlus: 3000x4000 10-bit mosaics written as 16-bit PNGs
    (utils/png), labelme JSONs of four "car" boxes a frame, and an 80-class
    darknet file (yolo/net.save_darknet_weights) of the port's seeded init;
    with pretrain_iters > 0 the criterion is pretrained first
    (pretrain_criterion) and read back from the file for a self-check.
    The frames are oneplus_frames'.  -> (data_root, weights path, the
    pretraining's stats or None).

    The build is cached on (n, seed, pretrain_iters), so a rerun of some
    phases freezes the criterion the recorded phases saw."""
    from reconfigisp_tpu_torch.utils import png
    from reconfigisp_tpu_torch.yolo.loss import decode_head
    from reconfigisp_tpu_torch.yolo.net import (
        init_yolo, load_darknet_weights, save_darknet_weights)

    data_root = os.path.join(root, "oneplus")
    os.makedirs(data_root, exist_ok=True)
    wpath = os.path.join(root, "yolov3.weights")
    cpath = os.path.join(root, "yolov3.weights.build.json")
    key = {"n": n, "seed": seed, "pretrain_iters": pretrain_iters}
    if os.path.exists(wpath) and os.path.exists(cpath):
        with open(cpath) as f:
            cached = json.load(f)
        if cached.get("key") == key:
            log(f"OnePlus fixtures: cache hit ({cpath}); reusing the "
                f"frozen criterion the previous phases recorded")
            return data_root, wpath, cached.get("stats")
    scenes, boxes = [], []
    for i, (scene, shapes, mosaic) in enumerate(
            oneplus_frames(n, seed, size)):
        png.write(os.path.join(data_root, f"{i:03d}.png"), mosaic)
        with open(os.path.join(data_root, f"{i:03d}.json"), "w") as f:
            json.dump({"shapes": shapes}, f)
        scenes.append(scene)
        boxes.append([(2, s["points"][0][0], s["points"][0][1],
                       s["points"][1][0], s["points"][1][1])
                      for s in shapes])  # "car" -> COCO class 2

    dev = resolve_device(device)
    blocks = _detector_blocks()
    net = init_yolo(blocks, torch.Generator().manual_seed(0), device=dev)
    stats = None
    if pretrain_iters:
        stats = pretrain_criterion(net, scenes, boxes, pretrain_iters)
    save_darknet_weights(net, wpath)
    log(f"OnePlus fixtures: {n} frames at {size[0]}x{size[1]}, 80-class "
        f"darknet "
        f"weights {os.path.getsize(wpath) / 1e6:.0f} MB"
        + (f", criterion pretrained {pretrain_iters} iters" if stats
           else " (random-init criterion)"))
    if stats is not None:
        # through the saved file, on the test's letterboxed view: catches
        # both a save/load drift and a train/test geometry skew
        reloaded = load_darknet_weights(blocks, wpath, device=dev)
        canvas, _ = _letterbox(scenes[0], DESIRED)
        with torch.no_grad():
            heads = reloaded(torch.from_numpy(
                np.ascontiguousarray(canvas[..., ::-1]))[None].to(dev))
            top_conf = max(float(decode_head(h, a, DESIRED)[1].max())
                           for h, a, _ in heads)
        stats["selfcheck_top_conf"] = round(top_conf, 4)
        log(f"criterion self-check (saved weights, clean test view): "
            f"top conf {top_conf:.3f}"
            + ("" if top_conf > 0.5 else "  <-- WEAK: the test mAP will "
               "suffer"))
    with open(cpath, "w") as f:
        json.dump({"key": key, "stats": stats}, f)
    return data_root, wpath, stats


def _crop_labels(boxes_lb, r0, c0, s):
    """Letterbox-coordinate boxes -> (16, 6) labels of the crop (r0, c0, s)
    under the dataset's visibility >= 0.5 rule."""
    lab = np.zeros((16, 6), np.float32)
    k = 0
    for cls, x0, y0, x1, y1 in boxes_lb:
        xa, xb = x0 - c0, x1 - c0
        ya, yb = y0 - r0, y1 - r0
        xav, xbv = np.clip([xa, xb], 0, s - 1)
        yav, ybv = np.clip([ya, yb], 0, s - 1)
        area = (xb - xa) * (yb - ya)
        vis = (xbv - xav) * (ybv - yav)
        if area <= 0 or vis / area < 0.5 or k >= 16:
            continue
        lab[k] = [1.0, cls, (xav + xbv) / 2 / s, (yav + ybv) / 2 / s,
                  (xbv - xav) / s, (ybv - yav) / s]
        k += 1
    return lab


def criterion_views(scenes, boxes, size, device=None):
    """The views the frozen criterion is pretrained on, in the geometry the
    OnePlus dataset shows it: per scene the clean letterboxed frame and its
    mosaic + Malvar re-render (the test's view), per box a size // 2 crop of
    the letterbox (a training crop), the first box's crop also re-rendered.
    -> {view size: (RGB images (N, S, S, 3), labels (N, 16, 6))} as
    tensors on `device`."""
    from reconfigisp_tpu_torch.ops import demosaic as dm

    def malvar(bgr):
        x = torch.from_numpy(_mosaic(bgr))[None, ..., None].to(device)
        return dm.demosaic_malvar(x)[0].clamp(0, 1).cpu().numpy()

    groups = {size: ([], []), size // 2: ([], [])}
    for scene, shapes in zip(scenes, boxes):
        canvas, (rh, rw, top) = _letterbox(scene, size)
        boxes_lb = [(cls, x0 * rw, y0 * rh + top, x1 * rw, y1 * rh + top)
                    for cls, x0, y0, x1, y1 in shapes]
        lab = _crop_labels(boxes_lb, 0, 0, size)
        for view in (canvas, malvar(canvas)):
            groups[size][0].append(view[..., ::-1])
            groups[size][1].append(lab)
        s2 = size // 2
        for bi, (cls, x0, y0, x1, y1) in enumerate(boxes_lb):
            r0 = int(np.clip((y0 + y1) / 2 - s2 / 2, 0, size - s2)) // 2 * 2
            c0 = int(np.clip((x0 + x1) / 2 - s2 / 2, 0, size - s2)) // 2 * 2
            lab2 = _crop_labels(boxes_lb, r0, c0, s2)
            if not lab2[:, 0].any():
                continue
            crop = canvas[r0:r0 + s2, c0:c0 + s2]
            groups[s2][0].append(crop[..., ::-1])
            groups[s2][1].append(lab2)
            if bi == 0:
                groups[s2][0].append(malvar(crop)[..., ::-1])
                groups[s2][1].append(lab2)
    return {s: (torch.from_numpy(np.stack(im).astype(np.float32)).to(device),
                torch.from_numpy(np.stack(lb)).to(device))
            for s, (im, lb) in groups.items() if im}


def pretrain_criterion(net, scenes, boxes, iters, size=None, lr=5e-4,
                       warmup=50, clip_norm=10.0, log_every=50):
    """A brief supervised pretraining of the frozen detection criterion,
    where it lies, by the JAX tool's recipe -> its stats.

    The reference freezes released darknet weights; none ship here, and a
    randomly initialised YOLOv3's loss has no structure the ISP's few
    parameters can reduce.  So the same 80-class graph is trained on
    criterion_views, two views a step, alternating between the two view
    sizes, each augmented by a channel gain U[0.85, 1.15], a gamma
    U[0.8, 1.25] and noise of sigma 0.02 (without them the criterion
    memorises its dozen views and fires on nothing else), drawn from a
    seeded torch.Generator on the net's device; the gradient's global norm
    clipped at `clip_norm`; the rate warmed up over `warmup` steps, then
    decayed by a cosine to 0.1 of `lr`; and the JAX package's Adam
    (utils/optim.adam_update: beta2 0.99, eps outside the root)."""
    from reconfigisp_tpu_torch.yolo.loss import yolo_loss
    size = size or DESIRED
    dev = next(net.parameters()).device
    data = criterion_views(scenes, boxes, size, dev)
    n_views = sum(v[0].shape[0] for v in data.values())
    log("criterion pretrain: " + ", ".join(
        f"{v[0].shape[0]} views @ {s}px" for s, v in sorted(data.items()))
        + f" ({n_views} total, letterbox geometry)")

    params = list(net.requires_grad_(True).parameters())
    moments = [torch.zeros_like(p) for p in params]
    squares = [torch.zeros_like(p) for p in params]
    beta1, beta2, eps = 0.9, 0.99, 1e-8
    rng = np.random.default_rng(7)
    gen = torch.Generator(device=dev).manual_seed(11)
    sizes = sorted(data)
    t0 = time.time()
    first = compile_s = t1 = loss = None
    for i in range(iters):
        x, y = data[sizes[i % len(sizes)]]
        nb = min(2, x.shape[0])
        idx = torch.from_numpy(rng.choice(x.shape[0], size=nb,
                                          replace=False)).to(dev)
        xb, yb = x[idx], y[idx]
        gain = 0.85 + 0.3 * torch.rand((nb, 1, 1, 3), generator=gen,
                                       device=dev)
        gamma = 0.8 + 0.45 * torch.rand((nb, 1, 1, 1), generator=gen,
                                        device=dev)
        xa = torch.clamp(xb * gain, 0.0, 1.0) ** gamma + 0.02 * torch.randn(
            xb.shape, generator=gen, device=dev)
        loss = yolo_loss(net(xa), yb, xb.shape[1])
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            factor = torch.clamp(clip_norm / (gnorm + 1e-12), max=1.0)
            frac = min(max((i + 1) / max(1, warmup), 0.0), 1.0)
            decay = 0.5 * (1 + math.cos(math.pi * min(max(
                (i - warmup) / max(1, iters - warmup), 0.0), 1.0)))
            rate = lr * frac * (0.1 + 0.9 * decay)
            bc1, bc2 = 1 - beta1 ** (i + 1), 1 - beta2 ** (i + 1)
            for p, g, m, v in zip(params, grads, moments, squares):
                g = g * factor
                m.mul_(beta1).add_(g, alpha=1 - beta1)
                v.mul_(beta2).addcmul_(g, g, value=1 - beta2)
                p.sub_(rate * (m / bc1) / (torch.sqrt(v / bc2) + eps))
        if i == 0:
            first = float(loss.detach())
            compile_s = time.time() - t0
            t1 = time.time()
        elif log_every and (i + 1) % log_every == 0:
            log(f"  criterion pretrain {i + 1}/{iters} "
                f"loss {float(loss.detach()):.1f}")
    final = float(loss.detach())
    net.requires_grad_(False)
    stats = {"iters": iters, "loss_first": round(first, 2),
             "loss": round(final, 2), "compile_s": round(compile_s, 2),
             "steady_s_per_iter": round(
                 (time.time() - t1) / max(1, iters - 1), 4)}
    log(f"criterion pretrain: loss {first:.1f} -> {final:.1f} "
        f"({stats['steady_s_per_iter']}s/iter @ {size}px)")
    return stats


def _detection(opt: dict, dataroot: str, weights: str, split: str) -> dict:
    """A detection config's `split` set at the fixtures, letterboxed to
    DESIRED, and its frozen evaluator at the fixtures' darknet file."""
    opt["datasets"][split]["dataroot"] = dataroot
    opt["datasets"][split]["desired_size"] = DESIRED
    opt["yolo"]["weights"] = weights
    opt["yolo"]["cfg"] = DETECTOR
    return opt


def run_yolo_leg(root, iters, learn_iters, phases=("search", "isp", "test"),
                 *, out=OUT_DIR, device=None, size=ONEPLUS_SIZE,
                 criterion_iters=None, search_iters=None):
    """The criterion's pretraining (max(300, learn_iters) steps unless
    criterion_iters), yolo_search.yaml (max(4, iters // 4) steps unless
    search_iters), yolo_isp.yaml (learn_iters) and yolo_test.yaml."""
    data_root, wpath, pstats = build_oneplus_fixtures(
        root, pretrain_iters=criterion_iters or max(300, learn_iters),
        size=size, device=device)
    res = {}
    if pstats:
        res["criterion_pretrain"] = pstats

    if "search" in phases:
        s_iters = search_iters or max(4, iters // 4)
        opt = _detection(_options("yolo_search", out, data_root), data_root,
                         wpath, "train")
        opt["dist"] = False
        s = run_training(opt, max_iters=s_iters, device=device)
        res["search"] = _phase(s, s_iters, "yolo", "search")
        log(f"yolo search ok: {res['search']}")

    if "isp" in phases:
        y_learn = max(4, learn_iters)
        opt = _detection(_options("yolo_isp", out, data_root), data_root,
                         wpath, "train")
        s = run_training(opt, max_iters=y_learn, device=device)
        res["isp"] = _phase(s, y_learn, "yolo", "isp")
        log(f"yolo isp ok: {res['isp']}")

    if "test" in phases:
        ckpt = _latest_ckpt(os.path.join(out, "experiments", "yolo_isp",
                                         "models", "*_G.ckpt"))
        res["test"] = _test(
            "yolo_test", out, root, data_root, ckpt, device,
            edit=lambda t: _detection(t, data_root, wpath, "test"))
        log(f"yolo {DESIRED}px test ok: {res['test']}")
    return res


def _run_test_cli(opt_path, device=None) -> dict:
    """The port's test CLI in this process -> the numbers of its summary
    lines (psnr_mean=...)."""
    from reconfigisp_tpu_torch import test as test_cli
    argv = ["--opt", opt_path]
    if device is not None:
        argv += ["--device", str(device)]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        test_cli.main(argv)
    res = {}
    for line in buf.getvalue().splitlines():
        if "=" in line:
            k, v = line.split("=", 1)
            try:
                res[k] = float(v)
            except ValueError:
                pass
    return res


def _size(text: str) -> tuple:
    h, w = text.lower().split("x")
    return int(h), int(w)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=None,
                    help="fixtures (default <out>/data)")
    ap.add_argument("--iters", type=int, default=30,
                    help="smoke budget for the search phases")
    ap.add_argument("--learn-iters", type=int, default=600,
                    help="learning budget for the fixed-pipeline phases")
    ap.add_argument("--legs", default="sid,s7,yolo")
    ap.add_argument("--phases", default="search,isp,test",
                    help="phase subset for any leg (e.g. 'isp,test' to "
                         "redo training and test without the search); "
                         "results merge into the existing leg entry")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--sid-size", type=_size, default=SID_SIZE,
                    help="SID frames, HxW (1424x2128)")
    ap.add_argument("--s7-size", type=_size, default=S7_SIZE,
                    help="S7 frames before the GRBG crop, HxW (3024x4032)")
    ap.add_argument("--oneplus-size", type=_size, default=ONEPLUS_SIZE,
                    help="OnePlus frames, HxW (3000x4000)")
    ap.add_argument("--criterion-iters", type=int, default=None,
                    help="the detection criterion's pretraining steps "
                         "(max(300, learn-iters))")
    ap.add_argument("--yolo-search-iters", type=int, default=None,
                    help="the detection search's steps (max(4, iters // 4))")
    args = ap.parse_args(argv)

    legs = args.legs.split(",")
    unknown = set(legs) - {"sid", "s7", "yolo"}
    if unknown:
        raise ValueError(f"unknown legs {sorted(unknown)}: sid, s7, yolo")
    dev = resolve_device(args.device)
    out = args.out
    root = args.root or os.path.join(out, "data")
    os.makedirs(root, exist_ok=True)
    rpath = os.path.join(out, "results.json")
    results = {}
    if os.path.exists(rpath):
        with open(rpath) as f:
            results = json.load(f)
    results["device"] = device_record(dev)
    phases = tuple(args.phases.split(","))
    runs = {"sid": lambda: run_sid_leg(root, args.iters, args.learn_iters,
                                       phases, out=out, device=dev,
                                       size=args.sid_size),
            "s7": lambda: run_s7_leg(root, args.iters, args.learn_iters,
                                     phases, out=out, device=dev,
                                     size=args.s7_size),
            "yolo": lambda: run_yolo_leg(
                root, args.iters, args.learn_iters, phases, out=out,
                device=dev, size=args.oneplus_size,
                criterion_iters=args.criterion_iters,
                search_iters=args.yolo_search_iters)}
    for leg, run in runs.items():
        if leg not in legs:
            continue
        results[leg] = {**results.get(leg, {}), **run()}
        with open(rpath, "w") as f:
            json.dump(results, f, indent=1)
    log("rehearsal complete:", json.dumps(results, indent=1))


if __name__ == "__main__":
    main()

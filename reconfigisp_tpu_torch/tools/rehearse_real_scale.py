"""Real-scale rehearsal: the shipped SID and S7 configs end to end at the
reference's data scale, on fabricated frames.

Counterpart of the SID and S7 legs of the repo's
tools/rehearse_real_scale.py, on the GPU unless `--device cpu` is given.
Each config runs as written, except its dataroot (the fixtures), `dist`
(one card) and the module bank (experiments/proxies/default.ckpt of the
checkout, which the port reads and never writes):

  SID leg — 1424x2128 14-bit RGGB frames (reference
            generate_rggb2bgr_imgs_SID_Sony.py:50), written as DNGs by
            data/dng.py and ingested by data/preprocessing.py, then
            configs/SID_search.yaml (3-step / 15-op native search, 48px
            crops) -> configs/SID_isp.yaml (192px fixed training) ->
            configs/SID_test.yaml (512/480 tiled full-frame test with
            exposure-pair selection).
  S7 leg  — 3024x4032 10-bit GRBG frames (reference
            generate_rggb2bgr_imgs_S7ISP_percentage.py:37-62), cropped to
            RGGB by preprocessing, then configs/S7ISP_search_ft.yaml
            (darts_ft search with online proxy tuning) ->
            configs/S7ISP_isp.yaml (384px fixed training) ->
            configs/S7ISP_test.yaml (512/480 tiled test).

The search phases are smoke-sized (--iters); the fixed-pipeline phases run
a learning budget (--learn-iters), so the results carry the loss's fall and
the test PSNR.  Each phase records compile_s apart from steady_s_per_iter,
and the reference's iteration budget projected at the steady rate.  Scenes
are upsampled with torch's bicubic interpolation and the GT is written as
.npy, so no cv2 is needed.  Writes <out>/results.json with the device's name
and power limit; the fixtures go under --root, the runs' experiment and
result trees under <out>.  The OnePlus/YOLO leg is not ported here.

Usage:  python -m reconfigisp_tpu_torch.tools.rehearse_real_scale
        [--root DIR] [--iters N] [--learn-iters N] [--legs sid,s7]
        [--phases search,isp,test] [--out DIR] [--device cpu]
        [--sid-size HxW] [--s7-size HxW]
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import io
import json
import os

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
          device) -> dict:
    """A test config as written, its test set at `dataroot`, the network
    `ckpt`, results under `out` -> the test CLI's summary."""
    with open(CONFIGS / f"{name}.yaml") as f:
        topt = yaml.safe_load(f)
    topt["datasets"]["test"]["dataroot"] = dataroot
    topt["path"]["pretrain_model_G"] = ckpt
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
    ap.add_argument("--legs", default="sid,s7")
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
    args = ap.parse_args(argv)

    legs = args.legs.split(",")
    unknown = set(legs) - {"sid", "s7"}
    if unknown:
        raise NotImplementedError(
            f"legs {sorted(unknown)}: only sid and s7 are ported; the "
            f"OnePlus/YOLO leg (its fixtures, the criterion's pretraining, "
            f"its search, training and test) is the port's next slice")
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
    for leg, run, size in (("sid", run_sid_leg, args.sid_size),
                           ("s7", run_s7_leg, args.s7_size)):
        if leg not in legs:
            continue
        res = run(root, args.iters, args.learn_iters, phases, out=out,
                  device=dev, size=size)
        results[leg] = {**results.get(leg, {}), **res}
        with open(rpath, "w") as f:
            json.dump(results, f, indent=1)
    log("rehearsal complete:", json.dumps(results, indent=1))


if __name__ == "__main__":
    main()

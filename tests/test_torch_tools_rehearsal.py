"""The port's real-scale rehearsal tool
(reconfigisp_tpu_torch/tools/rehearse_real_scale.py) against the JAX tool
of tools/: the phase records, the mosaics and the SID and S7 frame
fabrication from one given scene bit for bit; the scenes equal to rounding
(torch's bicubic upsampler for cv2's); small fixtures built by the port
read back alike by the JAX datasets and the port's; the OnePlus leg's
letterbox bit for bit and its fixtures (PNGs, labelme JSONs, the darknet
file's layout) against the JAX tool's; a fresh darts_ft run from the module
bank on S7 fixtures, the port against JAX at its first step; and the tool
end to end on the CPU at the smallest budgets into a temporary directory,
with the JAX results file's keys."""

import importlib.util
import json
import sys
from pathlib import Path

import cv2
import jax
import numpy as np
import pytest
import yaml

from reconfigisp_tpu import config as jconfig
from reconfigisp_tpu.data import create_dataset as jax_dataset
from reconfigisp_tpu.data import preprocessing as jax_pre
from reconfigisp_tpu.search.trainer import run_training as jax_run_training

from reconfigisp_tpu_torch import config
from reconfigisp_tpu_torch.data import create_dataset
from reconfigisp_tpu_torch.search.trainer import run_training
from reconfigisp_tpu_torch.tools import rehearse_real_scale as rr
from reconfigisp_tpu_torch.utils import png
from torch_one_thread import one_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
JAX_RESULTS = REPO / "experiments" / "rehearsal" / "results.json"
# cv2's INTER_CUBIC and torch's bicubic both take a = -0.75 at half-pixel
# centres, so the scenes part by float rounding (3.6e-6 at SID's 1424x2128)
SCENE_TOL = 1e-5
# the OnePlus mosaics truncate scene * 0.35 * 1023 to an integer, so scenes
# SCENE_TOL apart put at most a count's difference where a value lies
# within 0.35 * 1023 * SCENE_TOL (3.6e-3) of an integer: a few pixels in
# ten thousand
MOSAIC_SHARE = 1e-3
# losses of one step on the same data and weights (tests/test_torch_train.py)
LOSS_RTOL = 1e-5


@pytest.fixture(scope="module")
def jax_tool():
    spec = importlib.util.spec_from_file_location(
        "rehearse_real_scale_under_test",
        REPO / "tools" / "rehearse_real_scale.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("leg,phase", [
    ("sid", "search"), ("sid", "isp"), ("s7", "search_ft"), ("s7", "isp"),
    ("sid", "test")])
def test_phase_records_match_jax(jax_tool, leg, phase):
    summary = {"architecture": "Bayer_01_Demosaic_03_sRGB_13_13_13",
               "loss_first": 0.031, "loss": 0.026, "val_loss": 0.02,
               "compile_s": 12.5, "steady_s_per_iter": 0.5525,
               "loss_head_mean": None, "alpha_gap_max": 0.018,
               "alpha_top_minus_median": {"bayer": 0.018},
               "val_psnr_final": 33.9, "steps_run": 600, "steps": 600}
    got = rr._phase(summary, 600, leg, phase)
    want = jax_tool._phase(summary, 600, leg, phase)
    assert got == want and list(got) == list(want)
    assert rr.REF_BUDGETS == jax_tool.REF_BUDGETS


def test_mosaic_and_frames_bit_for_bit(jax_tool):
    """_mosaic, and the SID and S7 raws and GTs made from one given scene
    and generator state, as the JAX tool's fabricate and S7 loop make
    them."""
    scene = np.random.default_rng(4).uniform(0, 1, (32, 48, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(rr._mosaic(scene), jax_tool._mosaic(scene))

    raw, gt = rr._sid_frame(scene, np.random.default_rng(9))
    rng = np.random.default_rng(9)
    clean = jax_tool._mosaic(scene)
    short = clean / 100.0 + rng.normal(0, 0.002, clean.shape)
    want = np.clip(short * (16383 - 512) + 512, 0, 16383).astype(np.uint16)
    np.testing.assert_array_equal(raw, want)
    np.testing.assert_array_equal(gt, (scene * 255).astype(np.uint8))

    raw, gt = rr._s7_frame(scene, np.random.default_rng(9))
    rng = np.random.default_rng(9)
    grbg = jax_tool._mosaic(np.concatenate([scene[:, :1], scene],
                                           axis=1))[:, 1:]
    noisy = grbg + rng.normal(0, 0.01, grbg.shape)
    want = jax_pre.grbg_to_rggb(
        np.clip(noisy * 1023, 0, 1023).astype(np.uint16))
    assert raw.dtype == want.dtype == np.uint16
    np.testing.assert_array_equal(raw, want)
    np.testing.assert_array_equal(gt, scene[:, 1:-1])


def test_scenes_equal_to_rounding(jax_tool):
    """The same generator draws (the blended rectangles and every later
    draw agree) and bicubic bases equal to rounding."""
    h, w = 96, 160
    got = rr._smooth_scene(np.random.default_rng(1), h, w)
    want = jax_tool._smooth_scene(np.random.default_rng(1), h, w)
    assert got.shape == want.shape == (h, w, 3)
    assert got.dtype == want.dtype == np.float32
    assert float(np.abs(got - want).max()) <= SCENE_TOL
    rng_a, rng_b = np.random.default_rng(1), np.random.default_rng(1)
    rr._smooth_scene(rng_a, h, w)
    jax_tool._smooth_scene(rng_b, h, w)
    assert rng_a.random() == rng_b.random()


def _samples(make, opt):
    ds = make(opt)
    return [ds[i] for i in range(len(ds))]


def test_small_fixtures_read_alike_by_both_packages(tmp_path):
    """SID (64x96 DNGs -> folder pairs; a packed test set with exposure
    keys) and S7 (64x98 GRBG -> 64x96 RGGB folder pairs), built by the
    port, read by both packages' datasets bit for bit."""
    sid_train, sid_test = rr.build_sid_fixtures(str(tmp_path), size=(64, 96))
    s7_train, s7_test = rr.build_s7_fixtures(str(tmp_path), size=(64, 98))
    cases = [
        {"mode": "SID_Folder", "dataroot": sid_train, "data_size": None},
        {"mode": "SID_Records", "dataroot": sid_test, "data_size": None,
         "is_train": False, "sid_expo_in": "0.1s", "sid_expo_gt": "10s"},
        {"mode": "S7ISP_Folder", "dataroot": s7_train, "data_size": 48},
        {"mode": "S7ISP_Folder", "dataroot": s7_test, "data_size": None,
         "is_train": False},
    ]
    counts = []
    for opt in cases:
        got, want = _samples(create_dataset, opt), _samples(jax_dataset, opt)
        assert len(got) == len(want)
        counts.append(len(got))
        for a, b in zip(got, want):
            assert set(a) == set(b) == {"noisy", "gt"}
            for k in a:
                assert a[k].dtype == np.asarray(b[k]).dtype
                np.testing.assert_array_equal(a[k], np.asarray(b[k]))
        s = got[0]
        size = opt["data_size"] or 64
        assert s["noisy"].shape[:2] == s["gt"].shape[:2]
        assert s["noisy"].shape[0] == size and s["gt"].shape[-1] == 3
        assert 0.0 <= s["noisy"].min() and s["noisy"].max() <= 1.0
    assert counts == [2, 1, 2, 1]


@pytest.mark.parametrize("shape,desired", [
    ((64, 96, 3), 48), ((96, 64, 3), 32), ((300, 400, 3), 128),
    ((3000, 4000, 3), 1024)])
def test_letterbox_bit_for_bit(jax_tool, shape, desired):
    scene = np.random.default_rng(5).uniform(0, 1, shape).astype(np.float32)
    got, got_geom = rr._letterbox(scene, desired)
    want, want_geom = jax_tool._letterbox(scene, desired)
    assert got_geom == want_geom
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_oneplus_fixtures_match_jax(jax_tool, tmp_path):
    """Both tools' fixtures at 3000x4000 (the JAX tool's only size), with
    the random-init criterion: the labelme JSONs equal, the 16-bit mosaics
    equal but for the scenes' rounding, the darknet files of one layout
    (their draws differ: torch.Generator against JAX's key)."""
    want_root, want_w, want_stats = jax_tool.build_oneplus_fixtures(
        str(tmp_path / "jax"))
    got_root, got_w, got_stats = rr.build_oneplus_fixtures(
        str(tmp_path / "port"), device="cpu")
    assert got_stats is None and want_stats is None
    for i in range(2):
        for ext in (".json",):
            assert (json.loads(Path(got_root, f"{i:03d}{ext}").read_text())
                    == json.loads(Path(want_root, f"{i:03d}{ext}")
                                  .read_text()))
        got = png.read(Path(got_root, f"{i:03d}.png"))
        want = cv2.imread(str(Path(want_root, f"{i:03d}.png")),
                          cv2.IMREAD_UNCHANGED)
        assert got.dtype == want.dtype == np.uint16
        assert got.shape == want.shape == rr.ONEPLUS_SIZE
        diff = np.abs(got.astype(int) - want.astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() <= MOSAIC_SHARE
        assert got.max() <= 1023
    got_bytes, want_bytes = Path(got_w).read_bytes(), Path(want_w).read_bytes()
    assert len(got_bytes) == len(want_bytes)
    assert got_bytes[:20] == want_bytes[:20]
    # the cache: a second build of the same key reuses the files
    again = rr.build_oneplus_fixtures(str(tmp_path / "port"), device="cpu")
    assert again == (got_root, got_w, None)


def test_fresh_darts_ft_from_the_bank_matches_jax(tmp_path):
    """S7ISP_search_ft.yaml run fresh from the module bank on small S7
    fixtures, with the rehearsal's tuning overrides, in both packages: the
    first step's loss.  The supernet is cut to one step of 4 sRGB ops, so
    JAX's jit stays short; the path (the bank installed into a fresh
    darts_ft run) is the rehearsal's."""
    train_root, _ = rr.build_s7_fixtures(str(tmp_path / "data"),
                                         size=(64, 98))
    raw = yaml.safe_load((rr.CONFIGS / "S7ISP_search_ft.yaml").read_text())
    raw["datasets"]["train"].update(dataroot=train_root, batch_size=2,
                                    data_size=16)
    raw["network_G"].update(n_step=1, srgb_count=4)
    raw["proxy_ft_params"].update(ft_interval=2, ft_steps=2)
    raw["path"] = {"pretrain_proxies": str(rr.BANK)}
    raw["train"]["resume"] = False
    raw.update(use_tb_logger=False, dist=False)
    with jax.default_matmul_precision("highest"):
        want = jax_run_training(jconfig.parse_dict(
            raw, root=str(tmp_path / "jax")), max_iters=1)
    got = run_training(config.parse_dict(raw, root=str(tmp_path / "port")),
                       max_iters=1, device="cpu")
    assert got["steps_run"] == want["steps_run"] == 1
    assert got["loss_first"] == pytest.approx(want["loss_first"],
                                              rel=LOSS_RTOL)
    assert got["loss"] == pytest.approx(want["loss"], rel=LOSS_RTOL)


def _tiny_detection(monkeypatch):
    """The YOLO leg at CPU size: the configs' 80-class YOLOv3 for the
    miniature test graph of 80 classes, frames letterboxed to 128, crops of
    32 (search) and 64 (training), the test on the whole 128 frame."""
    monkeypatch.setattr(rr, "DETECTOR", "tiny_test")
    monkeypatch.setattr(rr, "DESIRED", 128)
    detection = rr._detection

    def small(opt, dataroot, weights, split):
        opt = detection(opt, dataroot, weights, split)
        opt["datasets"][split]["data_size"] = (
            128 if split == "test" else
            32 if opt["model"] == "darts_yolo" else 64)
        return opt

    monkeypatch.setattr(rr, "_detection", small)


def test_yolo_leg_end_to_end_on_the_cpu(tmp_path, monkeypatch):
    """The OnePlus leg with cv2 unimportable: fixtures of 256x320, the
    criterion pretrained 4 steps and read back for its self-check, one
    search step, the step-2 floor of 4 steps, the test's mAP; the JAX
    file's phases and keys (less the loss windows of 1 step)."""
    _tiny_detection(monkeypatch)
    monkeypatch.setitem(sys.modules, "cv2", None)
    out = tmp_path / "rehearsal"
    rr.main(["--legs", "yolo", "--device", "cpu", "--iters", "1",
             "--learn-iters", "2", "--criterion-iters", "4",
             "--yolo-search-iters", "1", "--oneplus-size", "256x320",
             "--out", str(out)])
    got = json.loads((out / "results.json").read_text())["yolo"]
    stored = json.loads(JAX_RESULTS.read_text())["yolo"]
    assert set(got) == set(stored)
    windows = {"loss_head_mean", "loss_tail_mean", "val_loss_head_mean",
               "val_loss_tail_mean"}
    assert set(got["criterion_pretrain"]) == set(
        stored["criterion_pretrain"])
    assert set(got["search"]) == set(stored["search"]) - windows
    assert set(got["isp"]) >= set(stored["isp"]) - windows
    assert got["criterion_pretrain"]["iters"] == 4
    assert 0.0 <= got["criterion_pretrain"]["selfcheck_top_conf"] <= 1.0
    assert got["search"]["steps_run"] == 1 and got["isp"]["steps_run"] == 4
    for rec in (got["criterion_pretrain"], got["search"], got["isp"]):
        assert np.isfinite(rec["loss"]) and np.isfinite(rec["loss_first"])
    assert 0.0 <= got["test"]["map"] <= 1.0
    frames = sorted((out / "results" / "yolo_test").glob("*.png"))
    assert [f.name for f in frames] == ["0000.png", "0001.png"]
    assert png.read(frames[0]).shape == (128, 128, 3)


def test_tool_end_to_end_on_the_cpu(tmp_path):
    """Both legs at the smallest budgets (1 search step, 2 learning steps,
    one test frame) on 512x512 frames (the test configs' 512 tile), into
    tmp_path: the JAX file's legs, phases and keys (less the loss windows,
    which need 4 steps), the card-or-CPU record, finite numbers."""
    out = tmp_path / "rehearsal"
    rr.main(["--legs", "sid,s7", "--device", "cpu", "--iters", "1",
             "--learn-iters", "2", "--out", str(out), "--sid-size",
             "512x512", "--s7-size", "512x514"])
    got = json.loads((out / "results.json").read_text())
    stored = json.loads(JAX_RESULTS.read_text())
    assert got["device"] == {"type": "cpu"}
    windows = {"loss_head_mean", "loss_tail_mean", "val_loss_head_mean",
               "val_loss_tail_mean"}
    for leg in ("sid", "s7"):
        assert set(got[leg]) == set(stored[leg])
        for phase, rec in got[leg].items():
            assert set(rec) == set(stored[leg][phase]) - windows, (leg, phase)
    for leg, search in (("sid", "search"), ("s7", "search_ft")):
        assert got[leg][search]["steps_run"] == 1
        assert got[leg]["isp"]["steps_run"] == 2
        for rec in (got[leg][search], got[leg]["isp"]):
            assert np.isfinite(rec["loss"]) and np.isfinite(rec["loss_first"])
        assert np.isfinite(got[leg]["test"]["psnr_mean"])
    assert (out / "experiments" / "SID_isp" / "models").is_dir()
    assert (out / "results" / "S7ISP_test").is_dir()

"""The port's command-line entry points, run as a user runs them, on the CPU.

  * python -m reconfigisp_tpu_torch.train on configs/synthetic_isp.yaml as
    it stands, 2 steps with --device cpu;
  * python -m reconfigisp_tpu_torch.test against the repo's JAX test.py on
    configs/synthetic_test.yaml, whole frames and split into tiles, from
    one JAX-saved pretrain_model_G: the printed psnr_mean within 1e-3 dB
    (both print 4 decimals; the pipelines agree within 1e-4 on each pixel,
    tests/test_torch_pipeline.py, far inside that in PSNR);
  * without --device cpu and without CUDA, every entry point exits non-zero
    saying CUDA is not available.

Each command runs in a subprocess whose working directory is a temporary
root, so the experiment and result trees land there.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

import reconfigisp_tpu as rj
from reconfigisp_tpu.utils import checkpoint as jcheckpoint

REPO = Path(__file__).resolve().parents[1]
PSNR_ATOL = 1e-3


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _run(args, cwd, timeout=300):
    return subprocess.run([sys.executable, *args], cwd=str(cwd), env=_env(),
                          capture_output=True, text=True, timeout=timeout)


def _psnr_mean(stdout: str) -> float:
    found = re.findall(r"^psnr_mean=([0-9.+-]+)$", stdout, re.M)
    assert len(found) == 1, stdout[-2000:]
    return float(found[0])


def test_train_cli_runs_synthetic_isp(tmp_path):
    r = _run(["-m", "reconfigisp_tpu_torch.train", "--opt",
              str(REPO / "configs" / "synthetic_isp.yaml"), "--niter", "2",
              "--device", "cpu"], tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "training done:" in r.stdout
    summary = r.stdout[r.stdout.index("training done:"):]
    assert "'steps': 2" in summary and "'steps_run': 2" in summary
    exp = tmp_path / "experiments" / "synthetic_isp"
    state = jcheckpoint.load_network(str(exp / "models" / "2_G.ckpt"))
    want = jcheckpoint._to_numpy(rj.Pipeline(
        "Bayer_02_Demosaic_03_sRGB_01_13_11").init(jax.random.PRNGKey(0)))
    assert sorted(state["logits"]) == sorted(want["logits"])
    for step, v in want["logits"].items():
        assert state["logits"][step].shape == v.shape
    assert (exp / "training_state" / "2.state").is_file()
    assert (exp / "metrics.jsonl").is_file()


@pytest.fixture(scope="module")
def test_options(tmp_path_factory):
    """configs/synthetic_test.yaml under a temporary root, whole and split,
    with a JAX-saved state whose logits are drawn away from their init."""
    root = tmp_path_factory.mktemp("cli_test")
    arch = yaml.safe_load(open(REPO / "configs" / "synthetic_test.yaml"))[
        "network_G"]["architecture"]
    state = jcheckpoint._to_numpy(rj.Pipeline(arch).init(
        jax.random.PRNGKey(3)))
    rng = np.random.default_rng(5)
    state["logits"] = {k: (v + rng.normal(0, 0.2, v.shape)).astype(
        np.float32) for k, v in state["logits"].items()}
    ckpt = jcheckpoint.save_network(str(root), "G", "jax", state)
    out = {}
    for mode in ("whole", "split"):
        opt = yaml.safe_load(open(REPO / "configs" / "synthetic_test.yaml"))
        opt["name"] = f"synthetic_test_{mode}"
        opt["path"] = {"root": str(root), "pretrain_model_G": ckpt}
        if mode == "split":
            opt["datasets"]["test"].update(patch_size=32, patch_stride=24)
        path = root / f"{mode}.yaml"
        path.write_text(yaml.safe_dump(opt))
        out[mode] = path
    return root, out


@pytest.mark.parametrize("mode", ["whole", "split"])
def test_test_cli_psnr_matches_jax(test_options, mode):
    root, opts = test_options
    jax_run = _run([str(REPO / "test.py"), "--opt", str(opts[mode]),
                    "--platform", "cpu"], root)
    assert jax_run.returncode == 0, jax_run.stderr[-3000:]
    port_run = _run(["-m", "reconfigisp_tpu_torch.test", "--opt",
                     str(opts[mode]), "--device", "cpu"], root)
    assert port_run.returncode == 0, port_run.stderr[-3000:]
    want, got = _psnr_mean(jax_run.stdout), _psnr_mean(port_run.stdout)
    assert abs(got - want) <= PSNR_ATOL, (got, want)
    assert 0.0 < got < 60.0
    results = root / "results" / f"synthetic_test_{mode}"
    assert (results / "0003.png").is_file()
    assert (results / "0000_strip.png").is_file() == (mode == "whole")
    log = (results / f"test_synthetic_test_{mode}.log").read_text()
    assert re.search(r"\[3\] psnr [0-9.]+ ssim [0-9.]+ \([0-9.]+ ms\)", log)
    assert "PSNR min" in log and "SSIM mean" in log


def test_test_cli_writes_arrays_without_cv2(monkeypatch, tmp_path):
    """Without cv2 the output frame and the strip are still written as the
    8-bit PNGs the JAX package writes (utils/png), which cv2 reads back."""
    import cv2
    from reconfigisp_tpu_torch import test as test_cli
    from reconfigisp_tpu_torch.utils.imaging import tensor2bgr
    monkeypatch.setitem(sys.modules, "cv2", None)
    frame = np.random.default_rng(0).uniform(0, 1, (6, 8, 3)).astype(
        np.float32)
    strip = np.concatenate([frame, frame], axis=1)
    test_cli._write(str(tmp_path), "0000", frame, strip)
    monkeypatch.setitem(sys.modules, "cv2", cv2)
    for name, want in (("0000.png", frame), ("0000_strip.png", strip)):
        got = cv2.imread(str(tmp_path / name), cv2.IMREAD_UNCHANGED)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, tensor2bgr(want))
    assert not list(tmp_path.glob("*.npy"))


@pytest.mark.skipif(torch.cuda.is_available(), reason="CUDA is present")
@pytest.mark.parametrize("entry", [
    ["-m", "reconfigisp_tpu_torch.train", "--opt",
     str(REPO / "configs" / "synthetic_isp.yaml"), "--niter", "1"],
    ["-m", "reconfigisp_tpu_torch.test", "--opt",
     str(REPO / "configs" / "synthetic_test.yaml")],
    ["-m", "reconfigisp_tpu_torch.search.proxy_pretrain", "--steps", "1",
     "--ops", "reinhard", "--size", "16", "--batch", "1"],
], ids=["train", "test", "proxy_pretrain"])
def test_entry_points_need_cuda_unless_cpu_is_named(entry, tmp_path):
    r = _run(entry, tmp_path, timeout=120)
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr
    assert not (tmp_path / "proxies.ckpt").exists()


def test_proxy_pretrain_cli_on_cpu(tmp_path):
    r = _run(["-m", "reconfigisp_tpu_torch.search.proxy_pretrain", "--steps",
              "2", "--ops", "reinhard,bilinear", "--size", "16", "--batch",
              "2", "--out", str(tmp_path / "bank.ckpt"), "--device", "cpu"],
             tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "saved 2 module weight sets" in r.stdout
    bank = jcheckpoint.load_network(str(tmp_path / "bank.ckpt"))
    assert sorted(bank) == ["bilinear", "reinhard"]


def test_entry_point_modules_import_no_jax():
    """The data layer, run_training, proxy pretraining and the CLIs pull in
    neither JAX nor the JAX package."""
    code = ("import sys, reconfigisp_tpu_torch.data, "
            "reconfigisp_tpu_torch.search.trainer, "
            "reconfigisp_tpu_torch.search.proxy_pretrain, "
            "reconfigisp_tpu_torch.train, reconfigisp_tpu_torch.test, "
            "reconfigisp_tpu_torch.utils.imaging, "
            "reconfigisp_tpu_torch.utils.logging_utils; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'reconfigisp_tpu' "
            "or m.startswith('reconfigisp_tpu.')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    r = _run(["-c", code], REPO, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr

"""The port's detector entry points against the JAX package's, on the CPU:
pretrain_yolo, evaluate_map and the test CLI's map= (run_training's
detection models are in tests/test_torch_yolo_run_training.py).

evaluate_map and the test CLI score a tiny_test detector that the port
pretrains here (600 steps, as tests/test_detection_validation.py does in
JAX, on clean synthetic scenes and the same at half the light, as the
pipeline renders the half-exposed mosaics) and writes as a darknet file.
The CLI runs configs/synthetic_yolo_test.yaml with that file and a pipeline
checkpoint written from the JAX side, in a subprocess whose working
directory is a temporary root, against the repo's JAX test.py.

Tolerances: mAP equal to the 4 printed decimals (the same numpy on
detections whose scores agree within 1e-6), the detection counts equal.
pretrain_yolo takes 3 Adam steps from one init: every weight within 1e-5
(2.1e-7 apart on the CPU).  Adam's first steps move each weight by about
lr sign(g), so a weight whose gradient lay within rounding of 0 could part
by 2 lr; none does on these inputs.
"""

import re

import jax
import numpy as np
import pytest
import torch
import yaml

import reconfigisp_tpu as rj
from reconfigisp_tpu.utils import checkpoint as jcheckpoint
from reconfigisp_tpu.yolo import cfg as jcfg
from reconfigisp_tpu.yolo import net as jnet
from reconfigisp_tpu.yolo import train as jtrain

from reconfigisp_tpu_torch import convert
from reconfigisp_tpu_torch.data.datasets import SyntheticDetectionDataset
from reconfigisp_tpu_torch.yolo import cfg, net as ynet, train

from test_torch_cli import REPO, _run
from torch_one_thread import one_thread  # noqa: F401  (autouse)

PRETRAIN_LR = 3e-3
WEIGHT_ATOL = 1e-5
S = 64


def _detection_data(n):
    ds = SyntheticDetectionDataset(n=n, size=S, seed=3)
    return (np.stack([ds[i]["gt"] for i in range(n)]),
            np.stack([ds[i]["label"] for i in range(n)]))


def test_pretrain_yolo_matches_jax():
    blocks = jcfg.yolov3_tiny_test_blocks(num_classes=1)
    jw = jnet.init_yolo(jax.random.PRNGKey(2), blocks)
    images, labels = _detection_data(6)
    with jax.default_matmul_precision("highest"):
        want = jtrain.pretrain_yolo(blocks, images, labels, S, steps=3,
                                    weights=jw, seed=4)
    start = convert.yolo_weights_from_jax(jax.tree.map(np.asarray, jw),
                                          ynet.YoloNet(blocks))
    got = train.pretrain_yolo(blocks, images, labels, S, steps=3,
                              net=start, seed=4)
    diffs = np.concatenate([
        np.abs(np.asarray(g) - np.asarray(w)).ravel()
        for g, w in zip(jax.tree.leaves(convert.yolo_weights_to_jax(got)),
                        jax.tree.leaves(jax.tree.map(np.asarray, want)))])
    moved = np.concatenate([
        np.abs(np.asarray(a) - np.asarray(b)).ravel()
        for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(jw))])
    assert moved.max() > PRETRAIN_LR
    assert diffs.max() <= WEIGHT_ATOL, np.sort(diffs)[-20:]


@pytest.fixture(scope="module")
def detector(tmp_path_factory):
    """A tiny_test detector the port pretrains on clean scenes and on the
    same at half the light, as a net and as a darknet file."""
    blocks = cfg.yolov3_tiny_test_blocks(1)
    images, labels = _detection_data(24)
    # 600 small steps: one thread, so parallel test workers do not
    # oversubscribe the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        net = train.pretrain_yolo(
            blocks, np.concatenate([images, 0.5 * images]),
            np.concatenate([labels, labels]), S, steps=600, seed=0,
            device="cpu")
    finally:
        torch.set_num_threads(threads)
    path = str(tmp_path_factory.mktemp("det") / "det.weights")
    ynet.save_darknet_weights(net, path)
    return blocks, net, path, images, labels


def test_evaluate_map_matches_jax(detector):
    blocks, net, path, images, labels = detector
    jw = jnet.load_darknet_weights(blocks, path)
    for conf in (0.3, 0.05):
        with jax.default_matmul_precision("highest"):
            want = jtrain.evaluate_map(jw, blocks, images, labels, S,
                                       conf_thres=conf)
        got = train.evaluate_map(net, images, labels, S, conf_thres=conf)
        assert want["mAP"] > 0.3
        assert f"{got['mAP']:.4f}" == f"{want['mAP']:.4f}"
        assert got["n_det"] == want["n_det"]


def test_test_cli_map_matches_jax(detector, tmp_path):
    """configs/synthetic_yolo_test.yaml through both test CLIs with one
    detector file and one JAX-written pipeline state: the same map= line,
    and the port keeps each frame's detections."""
    _, _, path, _, _ = detector
    opt = yaml.safe_load(open(REPO / "configs" / "synthetic_yolo_test.yaml"))
    state = jcheckpoint._to_numpy(rj.Pipeline(
        opt["network_G"]["architecture"]).init(jax.random.PRNGKey(3)))
    ckpt = jcheckpoint.save_network(str(tmp_path), "G", "jax", state)
    opt["yolo"]["weights"] = path
    opt["path"] = {"root": str(tmp_path), "pretrain_model_G": ckpt}
    opt_path = tmp_path / "yolo_test.yaml"
    opt_path.write_text(yaml.safe_dump(opt))
    runs = {
        "jax": _run([str(REPO / "test.py"), "--opt", str(opt_path),
                     "--platform", "cpu"], tmp_path),
        "port": _run(["-m", "reconfigisp_tpu_torch.test", "--opt",
                      str(opt_path), "--device", "cpu"], tmp_path)}
    maps = {}
    for side, r in runs.items():
        assert r.returncode == 0, r.stderr[-3000:]
        found = re.findall(r"^map=([0-9.]+)$", r.stdout, re.M)
        assert len(found) == 1, r.stdout[-2000:]
        maps[side] = found[0]
        assert "psnr_mean" not in r.stdout
    assert maps["port"] == maps["jax"]
    assert float(maps["port"]) > 0
    results = tmp_path / "results" / opt["name"]
    dets = np.load(results / "0007_dets.npy")
    assert dets.ndim == 2 and dets.shape[1] == 7 and len(dets) > 0

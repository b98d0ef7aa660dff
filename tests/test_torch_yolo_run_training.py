"""The port's run_training against the JAX package's for the detection
models darts_yolo and isp_yolo, on the CPU.

JAX's run_training saves its init at step 0 (niter 0); the experiment
directory is copied, and JAX and the port each resume from it for 2 steps,
under one frozen tiny_test detector written by JAX's save_darknet_weights
(the `yolo.weights` option of both).  The settings are tests/test_yolo.py's:
data_size 32, batch 2, srgb_count 4, n_step 1.  JAX runs at "highest"
matmul precision.

Tolerances are those of tests/test_torch_run_training.py: losses 1e-5
relative, alphas, theta and logits 1e-5.
"""

import json
import shutil

import jax
import numpy as np
import pytest
import torch

from reconfigisp_tpu import config as jconfig
from reconfigisp_tpu.search.trainer import run_training as jax_run_training
from reconfigisp_tpu.utils import checkpoint as jcheckpoint
from reconfigisp_tpu.yolo import cfg as jcfg
from reconfigisp_tpu.yolo import net as jnet

from reconfigisp_tpu_torch import config
from reconfigisp_tpu_torch.search import run_training
from reconfigisp_tpu_torch.yolo import cfg, net as ynet
from torch_one_thread import one_thread  # noqa: F401  (autouse)

STEPS = 2
LOSS_RTOL = 1e-5
ALPHA_ATOL = 1e-5
THETA_ATOL = 1e-5
LOGIT_ATOL = 1e-5


def _options(model, weights):
    opt = {"name": f"t_{model}", "model": model,
           "datasets": {"train": {"mode": "synthetic_yolo", "n": 16,
                                  "data_size": 32, "batch_size": 2}},
           "yolo": {"cfg": "tiny_test", "classes": 1, "weights": weights},
           "train": {"lr_G": 1e-3, "momentum_G": 0.9, "lr_meta": 1e-3,
                     "beta1": 0.9, "beta2": 0.99, "pixel_criterion": "l2",
                     "lr_scheme": "MultiStepLR", "lr_steps": [],
                     "manual_seed": 1},
           "logger": {"print_freq": 1, "save_checkpoint_freq": 1000}}
    if model == "darts_yolo":
        opt["network_G"] = {"n_step": 1, "prune_threshold": 0.2,
                            "srgb_count": 4}
    else:
        opt["network_G"] = {"architecture": "Bayer_02_Demosaic_02_sRGB_01"}
    return opt


@pytest.fixture(scope="module")
def tiny_file(tmp_path_factory):
    """A darknet file of JAX's tiny_test init."""
    blocks = jcfg.yolov3_tiny_test_blocks(num_classes=1)
    path = str(tmp_path_factory.mktemp("yolo") / "tiny.weights")
    jnet.save_darknet_weights(
        blocks, jnet.init_yolo(jax.random.PRNGKey(11), blocks), path)
    return path


@pytest.fixture(scope="module")
def runs(tmp_path_factory, tiny_file):
    cache = {}

    def get(model):
        if model in cache:
            return cache[model]
        tmp = tmp_path_factory.mktemp(model)
        opt = _options(model, tiny_file)
        name = opt["name"]
        start = json.loads(json.dumps(opt))
        start["train"]["niter"] = 0
        jax_run_training(jconfig.parse_dict(start, root=str(tmp / "init")))
        for side in ("jax", "port"):
            shutil.copytree(tmp / "init" / "experiments" / name,
                            tmp / side / "experiments" / name)
        opt["train"]["niter"] = STEPS
        with jax.default_matmul_precision("highest"):
            want = jax_run_training(jconfig.parse_dict(
                opt, root=str(tmp / "jax")))
        got = run_training(config.parse_dict(opt, root=str(tmp / "port")),
                           device="cpu")
        ckpt = {side: jcheckpoint.load_network(str(
            tmp / side / "experiments" / name / "models" / f"{step}_G.ckpt"))
            for side, step in (("jax", STEPS), ("port", STEPS), ("init", 0))}
        cache[model] = {"jax": want, "port": got, "ckpt": ckpt}
        return cache[model]

    return get


def _max_diff(got, want) -> float:
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        return max((_max_diff(got[k], want[k]) for k in want), default=0.0)
    return float(np.abs(np.asarray(got) - np.asarray(want)).max())


@pytest.mark.parametrize("model", ["darts_yolo", "isp_yolo"])
def test_run_training_matches_jax(runs, model):
    run = runs(model)
    got, want = run["port"], run["jax"]
    assert sorted(got) == sorted(want)
    assert got["steps"] == want["steps"] == STEPS
    assert got["steps_run"] == want["steps_run"] == STEPS
    assert "val_psnr" not in got and "val_psnr_final" not in got
    for k, v in want.items():
        if k in ("loss", "val_loss", "loss_first") or k.startswith(
                "probe_loss"):
            assert np.isfinite(got[k]) and got[k] > 0, k
            assert got[k] == pytest.approx(v, rel=LOSS_RTOL), k
    ckpt = run["ckpt"]
    if model == "darts_yolo":
        assert got["architecture"] == want["architecture"]
        assert _max_diff(ckpt["port"]["alphas"], ckpt["jax"]["alphas"]) \
            <= ALPHA_ATOL
        assert _max_diff(ckpt["port"]["theta"], ckpt["jax"]["theta"]) \
            <= THETA_ATOL
        assert _max_diff(ckpt["jax"]["alphas"], ckpt["init"]["alphas"]) > 0
    else:
        assert _max_diff(ckpt["port"]["logits"], ckpt["jax"]["logits"]) \
            <= LOGIT_ATOL
        assert _max_diff(ckpt["jax"]["logits"], ckpt["init"]["logits"]) > 0


def test_evaluator_without_weights_is_the_seeded_init():
    """No weights: the port's own init from seed 7, frozen."""
    from reconfigisp_tpu_torch.search.trainer import build_yolo_evaluator
    a = build_yolo_evaluator({"cfg": "tiny_test", "classes": 2}, "cpu")
    b = ynet.init_yolo(cfg.yolov3_tiny_test_blocks(2),
                       torch.Generator().manual_seed(7))
    assert not any(p.requires_grad for p in a.parameters())
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(p, q)
    full = build_yolo_evaluator({"cfg": "yolov3", "classes": 80}, "cpu")
    assert len(full.conv_blocks()) == 75

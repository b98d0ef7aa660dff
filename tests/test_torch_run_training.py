"""The port's run_training against the JAX package's, through checkpoints,
on the CPU.

For each model (isp and darts_ft here, darts in
tests/test_torch_run_training_darts.py): JAX's run_training runs K steps and
saves; the experiment directory is copied twice; JAX and the port each
resume from it to N steps.  Both resumed runs read the same state and the
same data stream (the isp branch skips the K x batch samples already drawn,
the search branch restarts its samplers at the saved epoch, and both move
the crop counters past every draw made before), so their summaries, and the
final variables in their N-step checkpoints (the JAX layout on both sides),
must agree.  The isp and darts cases train on SID-format packed records with
fresh random crops, which exercises the resume arithmetic; darts_ft on the
planted workload (its GT made by each package's own ops, within 1e-4).
The isp case also installs per-step weights (`module_weight_paths`) and
calibrates the latency table, whose keys must be JAX's; darts_ft installs
the in-repo module bank (`pretrain_proxies`) and runs one ft round at its
last step.  JAX runs at "highest" matmul precision.

Tolerances are those of tests/test_torch_train.py (losses 1e-5 relative,
logits 1e-5) and tests/test_torch_darts.py (alphas 3e-5, theta 1e-5).  The
probe PSNR is a log of the probe's mean square error, so 1e-5 relative in
the error is 5e-5 dB.  The summaries round the softmax gaps to 4 decimals:
within 1e-4 plus the alphas' tolerance.  The tuned proxies' weights move by
Adam steps of lr 1e-2 with relative gradient differences of about 1e-5: 1e-5
after 2 steps.
"""

import json
import shutil

import jax
import numpy as np
import pytest
import torch

from reconfigisp_tpu import config as jconfig
from reconfigisp_tpu import registry as jregistry
from reconfigisp_tpu.data.backends import PackedPairWriter
from reconfigisp_tpu.ops import cnn as jcnn
from reconfigisp_tpu.search.trainer import run_training as jax_run_training
from reconfigisp_tpu.utils import checkpoint as jcheckpoint

from reconfigisp_tpu_torch import config, registry
from reconfigisp_tpu_torch.search import run_training
from reconfigisp_tpu_torch.search.trainer import (
    _alpha_gap_summary, _probe_access_slack, dist_mesh)
from torch_one_thread import one_thread  # noqa: F401  (autouse)

K, N = 2, 4
LOSS_RTOL = 1e-5
LOGIT_ATOL = 1e-5
ALPHA_ATOL = 3e-5
THETA_ATOL = 1e-5
PSNR_ATOL = 5e-5
GAP_ATOL = 1e-4 + ALPHA_ATOL
OMEGA_ATOL = 1e-5
BANK = "experiments/proxies/default.ckpt"
SEARCH_TRAIN = {"lr_G": 1e-2, "momentum_G": 0.9, "lr_meta": 1e-2,
                "beta1": 0.9, "beta2": 0.99, "pixel_criterion": "l2",
                "lr_scheme": "MultiStepLR", "lr_steps": [3], "lr_gamma": 0.5,
                "manual_seed": 1}


def _records(root):
    """6 pairs of 40x56 uint16 14-bit raws and uint8 BGR GTs."""
    rng = np.random.default_rng(3)
    with PackedPairWriter(str(root)) as wr:
        for i in range(6):
            wr.add_pair(f"n{i}", rng.integers(0, 16384, (40, 56), np.uint16),
                        f"g{i}", rng.integers(0, 256, (40, 56, 3), np.uint8))
    return str(root)


def _options(case, tmp):
    if case == "isp":
        bayer = jcheckpoint.save_network(
            str(tmp), "bayer", "pre",
            jcnn.init_path14_bayer(jax.random.PRNGKey(42)))
        return {
            "name": "t_isp", "model": "isp",
            "datasets": {"train": {"mode": "SID_Records", "batch_size": 2,
                                   "dataroot": _records(tmp / "rec"),
                                   "data_size": 16}},
            "network_G": {"architecture": "Bayer_01_Demosaic_03_sRGB_01_11",
                          "module_weight_paths": {"step1_path_bayer": bayer}},
            "train": {"lr_G": 1e-2, "beta1": 0.9, "beta2": 0.99,
                      "pixel_criterion": "l2", "lr_scheme": "MultiStepLR",
                      "lr_steps": [3], "lr_gamma": 0.5, "manual_seed": 1},
            "logger": {"print_freq": 2, "val_freq": 3},
        }
    if case == "darts":
        return {
            "name": "t_darts", "model": "darts", "dist": True,
            "datasets": {"train": {"mode": "SID_Records", "batch_size": 2,
                                   "dataroot": _records(tmp / "rec"),
                                   "data_size": 16}},
            "network_G": {"n_step": 1, "prune_threshold": 0.2,
                          "srgb_count": 4},
            "train": dict(SEARCH_TRAIN),
            "logger": {"print_freq": 2},
        }
    return {
        "name": "t_ft", "model": "darts_ft",
        "datasets": {"train": {"mode": "synthetic_planted", "n": 8,
                               "data_size": 16, "batch_size": 2}},
        "proxy_ft_params": {"memory_size": 6, "ft_interval": N,
                            "ft_steps": 2},
        "network_G": {"n_step": 1, "prune_threshold": 0.2, "srgb_count": 4},
        "path": {"pretrain_proxies": BANK},
        "train": dict(SEARCH_TRAIN),
        "logger": {"print_freq": 2},
    }


def _with(opt, niter, save_freq, **train):
    opt = json.loads(json.dumps(opt))
    opt["train"].update(niter=niter, **train)
    opt["logger"]["save_checkpoint_freq"] = save_freq
    return opt


@pytest.fixture(scope="module")
def latency_restored():
    """run_training's calibration installs a table into both registries;
    both are restored afterwards."""
    port_before = dict(registry.LATENCY_MS_PER_MP)
    jax_before = {d: dict(jregistry.registry[d]) for d in jregistry.registry}
    yield
    registry.LATENCY_MS_PER_MP.update(port_before)
    for d, entries in jax_before.items():
        jregistry.registry[d].clear()
        jregistry.registry[d].update(entries)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, latency_restored):
    cache = {}

    def get(case):
        if case in cache:
            return cache[case]
        tmp = tmp_path_factory.mktemp(case)
        opt = _options(case, tmp)
        name = opt["name"]
        with jax.default_matmul_precision("highest"):
            first = jax_run_training(jconfig.parse_dict(
                _with(opt, K, K), root=str(tmp / "k")))
        for side in ("jax", "port"):
            shutil.copytree(tmp / "k" / "experiments" / name,
                            tmp / side / "experiments" / name)
        calib = {"calibrate_latency": True, "latency_calib_size": 16} \
            if case == "isp" else {}
        resumed = _with(opt, N, N, **calib)
        with jax.default_matmul_precision("highest"):
            want = jax_run_training(jconfig.parse_dict(
                resumed, root=str(tmp / "jax")))
        got = run_training(config.parse_dict(resumed, root=str(tmp / "port")),
                           device="cpu")
        ckpt = {side: jcheckpoint.load_network(str(
            tmp / side / "experiments" / name / "models" / f"{N}_G.ckpt"))
            for side in ("jax", "port")}
        cache[case] = {"first": first, "jax": want, "port": got,
                       "ckpt": ckpt, "tmp": tmp, "name": name}
        return cache[case]

    return get


def _assert_tree(got, want, atol, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree(got[k], want[k], atol, f"{what}/{k}")
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol,
                                       err_msg=f"{what}/{k}")


def _assert_summaries(got, want):
    assert sorted(got) == sorted(want)
    assert got["steps"] == want["steps"] == N
    assert got["steps_run"] == want["steps_run"] == N - K
    for k, v in want.items():
        if k in ("loss", "val_loss", "loss_first") or k.startswith(
                ("ft_", "probe_loss")):
            assert got[k] == pytest.approx(v, rel=LOSS_RTOL), k
        elif k.startswith("val_psnr"):
            assert got[k] == pytest.approx(v, abs=PSNR_ATOL), k


def assert_resumed_run_matches_jax(run, case):
    assert run["first"]["steps"] == K
    _assert_summaries(run["port"], run["jax"])
    got, want = run["ckpt"]["port"], run["ckpt"]["jax"]
    if case == "isp":
        _assert_tree(got["logits"], want["logits"], LOGIT_ATOL, "logits")
        assert sorted(got["weights"]) == sorted(want["weights"]) == [
            "path_bayer", "step1_path_bayer"]
        return
    _assert_tree(got["alphas"], want["alphas"], ALPHA_ATOL, "alphas")
    _assert_tree(got["theta"], want["theta"], THETA_ATOL, "theta")
    assert run["port"]["architecture"] == run["jax"]["architecture"]
    for slot, gap in run["jax"]["alpha_top_minus_median"].items():
        assert run["port"]["alpha_top_minus_median"][slot] == pytest.approx(
            gap, abs=GAP_ATOL)
    assert run["port"]["alpha_gap_max"] == pytest.approx(
        run["jax"]["alpha_gap_max"], abs=GAP_ATOL)


@pytest.mark.parametrize("case", ["isp", "darts_ft"])
def test_resumed_run_matches_jax(runs, case):
    assert_resumed_run_matches_jax(runs(case), case)


def test_ft_round_tunes_the_proxies_as_jax(runs):
    """darts_ft: the ft round at step N logs each tuned proxy's loss, and
    the proxy_<name> checkpoints agree."""
    run = runs("darts_ft")
    ft = sorted(k for k in run["jax"] if k.startswith("ft_"))
    assert ft == ["ft_crysisengine", "ft_filmic", "ft_reinhard"]
    models = {side: run["tmp"] / side / "experiments" / run["name"] / "models"
              for side in ("jax", "port")}
    for key in ft:
        name = key[3:]
        got, want = (jcheckpoint.load_network(
            str(models[side] / f"{N}_proxy_{name}.ckpt"))
            for side in ("port", "jax"))
        _assert_tree(got, want, OMEGA_ATOL, name)
        start = jcheckpoint.load_network(BANK)[name]
        assert float(np.abs(np.asarray(want["conv3"]["w"])
                            - start["conv3"]["w"]).max()) > 0


def test_calibrated_latency_table_and_weight_paths(runs):
    """The isp run's latency_table.json has JAX's keys, every value finite
    and positive; the per-step weights came from module_weight_paths, as
    JAX installs them."""
    run = runs("isp")
    tables = {side: json.loads((run["tmp"] / side / "experiments"
                                / run["name"] / "latency_table.json")
                               .read_text()) for side in ("jax", "port")}
    assert sorted(tables["port"]) == sorted(tables["jax"])
    assert all(np.isfinite(v) and v > 0 for v in tables["port"].values())
    want = jcheckpoint._to_numpy(jcnn.init_path14_bayer(
        jax.random.PRNGKey(42)))
    got = run["ckpt"]["port"]["weights"]["step1_path_bayer"]
    np.testing.assert_array_equal(got["conv_first"]["w"],
                                  want["conv_first"]["w"])


def test_helpers():
    gaps = _alpha_gap_summary({"a": torch.tensor([0.0, 0.0, 0.0]),
                               "b": np.array([2.0, 0.0, 0.0], np.float32)})
    assert gaps["alpha_top_minus_median"]["a"] == 0.0
    assert gaps["alpha_gap_max"] == gaps["alpha_top_minus_median"]["b"] > 0.5
    assert _probe_access_slack({"logger": {"val_freq": 5}}, 12) == 2 * 3
    assert _probe_access_slack({}, 12) == 2
    assert dist_mesh(4) is None  # no process group: serial


@pytest.mark.parametrize("model,match", [("nope", "unknown model")])
def test_unported_models_raise(model, match, tmp_path):
    opt = config.parse_dict({"model": model, "train": {}},
                            root=str(tmp_path))
    with pytest.raises(ValueError, match=match):
        run_training(opt, device="cpu")


def test_trace_steps_write_a_chrome_trace(tmp_path):
    """train.trace_steps [a, b]: a torch.profiler trace of steps a+1..b as
    a Chrome trace under <experiments>/trace (the JAX package's
    jax.profiler trace), with the steps' spans (utils/tracing.py) among its
    annotations and in spans.json beside it; eager steps have no graph."""
    opt = _options("darts", tmp_path)
    opt = _with(opt, 2, 0, trace_steps=[0, 2])
    summary = run_training(config.parse_dict(opt, root=str(tmp_path / "r")),
                           device="cpu")
    assert summary["steps"] == 2
    out = tmp_path / "r" / "experiments" / "t_darts" / "trace"
    trace = json.loads((out / "trace.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("conv" in n for n in names)
    assert {"darts.step", "darts.virtual", "darts.update"} <= names
    spans = json.loads((out / "spans.json").read_text())
    assert spans["graph"] is None
    steps = [s for s in spans["spans"] if s["parent"] is None]
    assert [s["name"] for s in steps] == ["darts.step"] * 2
    assert [s["request"] for s in steps] == [0, 1]
    assert all(s["host_s"] > 0 for s in spans["spans"])

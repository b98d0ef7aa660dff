"""Search with online proxy tuning in the port against the JAX package, on
the CPU: dct_denoise (bm3d's tuning target) and DartsFtTrainer.

Inputs are numpy draws.  JAX matmuls and convolutions run at "highest"
precision (this JAX build defaults to bf16 on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reconfigisp_tpu.ops import denoise as jdenoise
from reconfigisp_tpu.search.trainer import DartsFtTrainer as JaxDartsFtTrainer
from reconfigisp_tpu.supernet import SuperNet as JaxSuperNet
from reconfigisp_tpu.utils.checkpoint import _to_numpy

from reconfigisp_tpu_torch import convert, registry
from reconfigisp_tpu_torch.ops import denoise
from reconfigisp_tpu_torch.search import DartsFtTrainer
from reconfigisp_tpu_torch.supernet import SuperNet
from reconfigisp_tpu_torch.utils.checkpoint import load_network

# ------------------------------------------------------------- dct_denoise

# dct_denoise: the same b x b transforms as float32 matmuls in another
# order, about 1e-5 on the 0..255 scale; the output is on 0..1, so 1e-5
# leaves room.  A coefficient within that of the hard threshold could flip;
# the seeded draws below hold none.
DCT_ATOL = 1e-5


def _dct_params(block8: bool, swap: bool) -> np.ndarray:
    """Two images: DCT with RGB aggregation uniform, and WHT in the opponent
    space with sparsity weights (swapped by `swap`); thresholds and blends
    differ; the block size is the batch's."""
    n1 = 0.8 if block8 else 0.2
    rows = [[0.15, n1, 0.2, 0.3, 0.9], [0.35, n1, 0.7, 0.8, 0.6]]
    return np.asarray(rows[::-1] if swap else rows, np.float32)


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("block8", [False, True], ids=["b4", "b8"])
@pytest.mark.parametrize("swap", [False, True], ids=["dct_rgb", "wht_opp"])
def test_dct_denoise_matches_jax(c, block8, swap):
    rng = np.random.default_rng(81 + c)
    x = rng.uniform(0.0, 1.0, (2, 30, 34, c)).astype(np.float32)
    p = _dct_params(block8, swap)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jdenoise.dct_denoise(jnp.asarray(x),
                                               jnp.asarray(p)))
    got = denoise.dct_denoise(torch.from_numpy(x), torch.from_numpy(p))
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, atol=DCT_ATOL, rtol=0)
    assert float(np.abs(want - x).max()) > 0.05   # it did denoise


def test_bm3d_targets_dct_denoise():
    spec = registry.get_op("srgb", "bm3d")
    assert spec.ft_target and spec.ft_target_fn() is denoise.dct_denoise
    ft = [s.name for s in registry.pool("srgb") if s.ft_target]
    assert ft == ["reinhard", "crysisengine", "filmic", "whiteworld",
                  "bilateral", "median", "fastnlm", "bm3d"]
    assert registry.get_op("srgb", "median").ft_target_fn() is \
        registry.get_op("srgb", "median").apply


# ---------------------------------------------------------- DartsFtTrainer

# srgb 9 with proxies: ft ops reinhard, crysisengine, filmic, whiteworld,
# bilateral, median and fast-NLM, whose targets are the native windowed ops
# (bm3d's is dct_denoise, held above).  planted_search_ft.yaml's
# optimiser; ft_steps 2, memory 5.
TRAIN_OPT = {"lr_G": 1e-2, "momentum_G": 0.9, "lr_meta": 1e-2, "beta1": 0.9,
             "beta2": 0.99, "pixel_criterion": "l2", "manual_seed": 10}
FT = {"memory_size": 5, "ft_steps": 2, "ft_interval": 3}
# Tolerances.  The search agrees as in tests/test_torch_darts.py.  An ft
# step moves each weight by lr m_hat / (sqrt(v_hat) + 1e-8).  A relative
# error e of its gradient moves that by about lr e: the gradients differ by
# about 1e-4 relative (the replayed data 1e-5 apart, the targets' plain
# forms 2e-5 from the jnp forms, convolutions reordered), 1e-6 a step at
# lr 1e-2, so the bulk of the weights agree within OMEGA_ATOL = 1e-5.  But
# for a gradient near Adam's 1e-8 an absolute rounding error of the same
# size moves the step by up to lr: such weights are rare, as gradients
# spread over decades, so at most OMEGA_OUTLIERS of an op's weights (1 in
# 10^4) may part by more, none by more than the steps' bound 2 lr ft_steps, and the
# tuned proxies' outputs agree within PROXY_ATOL = 1e-4 (the SRCNN forward's
# own 1e-5 and what the outlying weights add).
OMEGA_ATOL = 1e-5
OMEGA_OUTLIERS = 1e-4
PROXY_ATOL = 1e-4
FT_LOSS_RTOL = 1e-3   # the last ft step's loss, a mean square of 1e-4-size
                      # residuals


def _batches():
    rng = np.random.default_rng(91)
    mk = lambda c: rng.uniform(0.05, 0.95, (2, 32, 32, c)).astype(np.float32)
    return [({"noisy": mk(1), "gt": mk(3)}, {"noisy": mk(1), "gt": mk(3)})
            for _ in range(3)]


@pytest.fixture(scope="module")
def ft_runs(tmp_path_factory):
    """JAX and port trainers from the JAX init: 3 search steps, each
    recorded into the memory, then one finetune_proxies; both saved."""
    root = tmp_path_factory.mktemp("ft")
    jt = JaxDartsFtTrainer(JaxSuperNet(1, 0.2, use_proxies=True,
                                       srgb_count=9), TRAIN_OPT, FT,
                           key=jax.random.PRNGKey(0))
    net = SuperNet(1, 0.2, use_proxies=True, srgb_count=9, device="cpu")
    pt = DartsFtTrainer(net, TRAIN_OPT, FT)
    pt.variables = convert.supernet_variables_from_jax(
        _to_numpy(jt.variables), net)
    pt._make_ft_optimizers()   # over the carried-in modules
    out = {"jax": jt, "port": pt, "root": root, "start": _to_numpy(
        jt.variables["omega"]), "logs": []}
    with jax.default_matmul_precision("highest"):
        for tb, vb in _batches():
            out["logs"].append((pt.search_step(tb, vb),
                                jt.search_step(tb, vb)))
            pt.record_intermediates(tb)
            jt.record_intermediates(tb)
        out["memory"] = (len(pt.ft_data), len(jt.ft_data))
        out["ft"] = (pt.finetune_proxies(), jt.finetune_proxies())
    for name, t in (("port", pt), ("jax", jt)):
        t.save(str(root / name / "models"), str(root / name / "state"),
               epoch=1)
    return out


def test_search_steps_match_jax(ft_runs):
    for logs, jlogs in ft_runs["logs"]:
        assert logs["loss"] == pytest.approx(jlogs["loss"], rel=1e-5)
        assert logs["val_loss"] == pytest.approx(jlogs["val_loss"], rel=1e-5)
    got = convert.supernet_variables_to_jax(ft_runs["port"].variables)
    want = _to_numpy(ft_runs["jax"].variables)
    for slot, a in want["alphas"].items():
        np.testing.assert_allclose(got["alphas"][slot], a, atol=3e-5, rtol=0)


def test_memory_is_a_fifo_of_the_training_pass(ft_runs):
    """2 sRGB intermediates a step (demosaic and step1), 3 steps, memory 5:
    the oldest dropped; the last entries are the last step's, as JAX's."""
    assert ft_runs["memory"] == (5, 5)
    pt, jt = ft_runs["port"], ft_runs["jax"]
    for got, want in zip(pt.ft_data, jt.ft_data):
        assert tuple(got.shape) == want.shape == (2, 32, 32, 3)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_finetune_matches_jax(ft_runs):
    """Every ft op's omega after one finetune_proxies (2 Adam steps each, on
    the same draws of the same generator), and its last loss."""
    pt, jt = ft_runs["port"], ft_runs["jax"]
    logs, jlogs = ft_runs["ft"]
    names = [s.name for s in pt.ft_ops]
    assert names == [s.name for s in jt.ft_ops] == [
        "reinhard", "crysisengine", "filmic", "whiteworld", "bilateral",
        "median", "fastnlm"]
    assert sorted(logs) == sorted(jlogs) == sorted(f"ft_{n}" for n in names)
    for k in jlogs:
        assert np.isfinite(logs[k])
        assert logs[k] == pytest.approx(jlogs[k], rel=FT_LOSS_RTOL), k
    for name in names:
        got = convert.weights_to_jax(dict(
            pt.variables["omega"][name].named_parameters()))
        want = _to_numpy(jt.variables["omega"][name])
        start = ft_runs["start"][name]
        diff = np.concatenate([np.abs(a - b).ravel() for a, b in zip(
            jax.tree.leaves(got), jax.tree.leaves(want))])
        assert diff.max() <= 2 * TRAIN_OPT["lr_G"] * FT["ft_steps"], name
        assert np.mean(diff > OMEGA_ATOL) <= OMEGA_OUTLIERS, (
            name, int(np.sum(diff > OMEGA_ATOL)), diff.size, diff.max())
        spec = pt.ft_ops[names.index(name)]
        data = np.array(jt.ft_data[-1])   # a writable copy
        p = np.full((2, spec.n_params), 0.5, np.float32)
        with torch.no_grad():
            y = spec.proxy_apply(torch.from_numpy(data), torch.from_numpy(p),
                                 pt.variables["omega"][name])
        with jax.default_matmul_precision("highest"):
            jy = jt.ft_ops[names.index(name)].proxy_apply(
                jnp.asarray(data), jnp.asarray(p),
                jt.variables["omega"][name])
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0,
                                   atol=PROXY_ATOL, err_msg=name)
        moved = max(float(np.abs(a - s).max()) for a, s in zip(
            jax.tree.leaves(got), jax.tree.leaves(start)))
        assert moved > 1e-3, name


def test_save_writes_each_proxy_readable_by_jax(ft_runs):
    """proxy_<name> per ft op beside the network, in the JAX layout: the
    port's holds the port's tuned weights and has the JAX file's tree."""
    pt = ft_runs["port"]
    models = ft_runs["root"] / "port" / "models"
    jmodels = ft_runs["root"] / "jax" / "models"
    for spec in pt.ft_ops:
        got = load_network(str(models / f"3_proxy_{spec.name}.ckpt"))
        want = load_network(str(jmodels / f"3_proxy_{spec.name}.ckpt"))
        assert jax.tree.structure(got) == jax.tree.structure(want)
        mine = convert.weights_to_jax(dict(
            pt.variables["omega"][spec.name].named_parameters()))
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(mine)):
            np.testing.assert_array_equal(a, b)
    assert (models / "3_G.ckpt").exists()


def test_ft_trainer_needs_proxies():
    with pytest.raises(ValueError, match="use_proxies"):
        DartsFtTrainer(SuperNet(1, 0.2, srgb_count=6, device="cpu"),
                       TRAIN_OPT, FT)

"""The port's proxy pretraining (step 0) against the JAX package's, on the
CPU.

One op of each plan kind (an sRGB proxy whose target is the windowed
median, the Malvar demosaic proxy "laplacian", and the native path_bayer)
trains 3 steps in both packages from the JAX initial weights, carried into
the port with convert.weights_from_jax.  The ops run in one subset, in the
JAX package's plan order, so the numpy generator that draws the median's
params and path_bayer's noise is shared as in JAX: a reordered draw gives
other samples, and other weights.  JAX convolutions run at "highest"
precision.

Tolerances.  Both take the same samples; the forward passes differ by the
convolutions' order of summation (about 1e-6 relative), and the gradients
by as much.  Adam moves a weight by lr m_hat / (sqrt(v_hat) + eps), a ratio
that a relative change e of the gradient moves by about e, so 3 steps at lr
1e-3 keep the weights within WEIGHT_ATOL = 1e-5 of each other (as in
tests/test_torch_train.py).  The losses each step prints have 4
significant digits (1e-3 relative); the final weights' loss on a probe
batch is compared in full, within 1e-5 relative.
"""

import contextlib
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reconfigisp_tpu.registry import pool as jpool
from reconfigisp_tpu.search import proxy_pretrain as jpp
from reconfigisp_tpu.utils import checkpoint as jcheckpoint

from reconfigisp_tpu_torch import convert
from reconfigisp_tpu_torch.registry import pool
from reconfigisp_tpu_torch.search import proxy_pretrain as pp
from reconfigisp_tpu_torch.utils import checkpoint
from torch_one_thread import one_thread  # noqa: F401  (autouse)

OPS = ("median", "laplacian", "path_bayer")   # plan order
STEPS, BATCH, SIZE, SEED = 3, 2, 16, 4
WEIGHT_ATOL = 1e-5
PRINTED_RTOL = 1e-3
PROBE_RTOL = 1e-5
_STEP_LINE = re.compile(r"\[(\w+)\] step (\d+)/\d+ l2 ([0-9.e+-]+)")


def _specs():
    return {s.name: s for d in ("bayer", "demosaic", "srgb") for s in jpool(d)}


def _jax_inits():
    """The initial weights JAX's pretrain_modules draws for OPS: one key
    split per op, in plan order."""
    key = jax.random.PRNGKey(SEED)
    specs = _specs()
    inits = {}
    for name in OPS:
        key, k = jax.random.split(key)
        spec = specs[name]
        init = spec.init_weights if name == "path_bayer" else spec.proxy_init
        inits[name] = jcheckpoint._to_numpy(init(k))
    return inits


def _losses(text):
    out = {}
    for name, _, loss in _STEP_LINE.findall(text):
        out.setdefault(name, []).append(float(loss))
    return out


@pytest.fixture(scope="module")
def runs():
    """JAX's pretrain_modules over OPS, and the port's plans over OPS from
    the JAX initial weights, each with its printed per-step losses."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            jax.default_matmul_precision("highest"):
        jtrained = jpp.pretrain_modules(STEPS, batch=BATCH, size=SIZE,
                                        seed=SEED, ops=set(OPS), log_every=1)
    jax_losses = _losses(buf.getvalue())

    inits = _jax_inits()
    rng = np.random.default_rng(SEED)
    plans = pp.make_plans(BATCH, SIZE, SEED, 0.06, rng)
    assert [p.name for p in plans if p.name in OPS] == list(OPS)
    buf = io.StringIO()
    trained, finals = {}, {}
    with contextlib.redirect_stdout(buf):
        for plan in plans:
            if plan.name not in OPS:
                continue
            module = plan.init(torch.Generator())
            module.load_state_dict(convert.weights_from_jax(inits[plan.name]))
            module, _, finals[plan.name], _ = pp.train_plan(
                plan, module, STEPS, lr=1e-3, log_every=1)
            trained[plan.name] = module
    return {"jax": jtrained, "jax_losses": jax_losses, "inits": inits,
            "port": trained, "port_losses": _losses(buf.getvalue()),
            "finals": finals}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix: np.asarray(tree)}


@pytest.mark.parametrize("name", OPS)
def test_weights_match_jax(runs, name):
    got = _flat(convert.weights_to_jax(
        dict(runs["port"][name].named_parameters())))
    want = _flat(jcheckpoint._to_numpy(runs["jax"][name]))
    start = _flat(runs["inits"][name])
    assert sorted(got) == sorted(want)
    moved = max(float(np.abs(want[k] - start[k]).max()) for k in want)
    assert moved > 1e-4   # the weights compared did move
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=WEIGHT_ATOL,
                                   err_msg=f"{name} {k}")


@pytest.mark.parametrize("name", OPS)
def test_losses_match_jax(runs, name):
    """Each step's printed loss; the last one is train_plan's return."""
    assert len(runs["port_losses"][name]) == STEPS
    np.testing.assert_allclose(runs["port_losses"][name],
                               runs["jax_losses"][name], rtol=PRINTED_RTOL)
    assert float(f"{runs['finals'][name]:.3e}") == runs["port_losses"][name][-1]


def test_probe_loss_of_trained_median_proxy_matches_jax(runs):
    """The trained median proxy against its target on a probe batch, in
    both packages: the same l2 in full precision."""
    spec = {s.name: s for s in jpool("srgb")}["median"]
    pspec = {s.name: s for s in pool("srgb")}["median"]
    rng = np.random.default_rng(9)
    x = rng.uniform(0.05, 0.95, (2, SIZE, SIZE, 3)).astype(np.float32)
    p = np.full((2, 1), 0.6, np.float32)
    with jax.default_matmul_precision("highest"):
        jy = spec.proxy_apply(jnp.asarray(x), jnp.asarray(p),
                              runs["jax"]["median"])
        jt = spec.apply(jnp.asarray(x), jnp.asarray(p), None)
        want = float(jnp.mean((jy - jt) ** 2))
    with torch.no_grad():
        xt, pt = torch.from_numpy(x), torch.from_numpy(p)
        y = pspec.proxy_apply(xt, pt, runs["port"]["median"])
        got = float(torch.mean((y - pspec.apply(xt, pt, None)) ** 2))
    assert got == pytest.approx(want, rel=PROBE_RTOL)


def test_pretrain_modules_and_checkpoint(tmp_path):
    """The port's pretrain_modules on the CPU: JAX-layout pytrees with the
    JAX initial weights' structure, a report per op, a checkpoint that
    reads back; the plans cover every learned module."""
    report = {}
    trained = pp.pretrain_modules(2, batch=2, size=16, ops={"bilinear",
                                                            "bm3d"},
                                  device="cpu", verbose=False, report=report)
    assert sorted(trained) == sorted(report) == ["bilinear", "bm3d"]
    specs = _specs()
    for name, tree in trained.items():
        want = _flat(jcheckpoint._to_numpy(
            specs[name].proxy_init(jax.random.PRNGKey(0))))
        got = _flat(tree)
        assert {k: v.shape for k, v in got.items()} == \
            {k: v.shape for k, v in want.items()}
        assert np.isfinite(report[name]["loss"])
        assert report[name]["first_loss"] != report[name]["loss"]
        assert report[name]["s_per_step"] > 0
    path = checkpoint.save_network(str(tmp_path), "proxies", "t", trained)
    back = jcheckpoint.load_network(path)
    np.testing.assert_array_equal(back["bm3d"]["conv1"]["w"],
                                  trained["bm3d"]["conv1"]["w"])
    names = {p.name for p in pp.make_plans(1, 8, 0, 0.06,
                                           np.random.default_rng(0))}
    assert names == {"reinhard", "crysisengine", "filmic", "whiteworld",
                     "bilateral", "median", "fastnlm", "bm3d", "bilinear",
                     "laplacian", "demosaicnet", "path_bayer", "path_bgr"}

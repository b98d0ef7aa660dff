"""Where the port's results could part from the JAX package's beyond the
forward pass on random input: a per-step weight override, the median's
gradient at tied taps, and clip gradients at an exact bound, each against
the JAX package on the CPU."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reconfigisp_tpu as rj
from reconfigisp_tpu.ops import color as jcolor
from reconfigisp_tpu.ops import denoise as jdenoise
from reconfigisp_tpu.utils.checkpoint import _to_numpy

import reconfigisp_tpu_torch as rt
from reconfigisp_tpu_torch import convert
from reconfigisp_tpu_torch.ops import color
from reconfigisp_tpu_torch.ops.kernels import median as km
from reconfigisp_tpu_torch.ops.nn import clip
from reconfigisp_tpu_torch.utils.checkpoint import load_network
from torch_one_thread import one_thread  # noqa: F401  (autouse)

SLICE = "Bayer_01_Demosaic_03_sRGB_07_01_13_11"
SLICE2 = "Bayer_01_Demosaic_03_sRGB_08_09_01_13_11"
FLAGSHIP = "Bayer_01_Demosaic_03_sRGB_01_13_11"
CKPT = str(Path(__file__).resolve().parents[1] / "experiments" / "proxies"
           / "default.ckpt")


def _saturated(shape, seed):
    """Uniform noise stretched and clipped: about a quarter of the values
    exactly 0 and a quarter exactly 1, as in clipped highlights."""
    u = np.random.default_rng(seed).uniform(0, 1, shape)
    return np.clip(2 * u - 0.5, 0, 1).astype(np.float32)


# ------------------------------------------------------------ per-step weights

def _override_state(arch):
    """The JAX init state of `arch` with `step1_path_bayer` set to the bank's
    path_bayer weights, perturbed, beside the op-keyed init weights."""
    bank = load_network(CKPT)
    rng = np.random.default_rng(61)
    override = jax.tree.map(
        lambda a: (a * (1.0 + 0.2 * rng.standard_normal(a.shape))).astype(
            np.float32), bank["path_bayer"])
    st = _to_numpy(rj.Pipeline(arch).init(jax.random.PRNGKey(0)))
    st["weights"]["step1_path_bayer"] = override
    return st


def _port(arch, np_state):
    return rt.Pipeline(arch, device="cpu").load_state(
        convert.state_from_jax(np_state))


def test_step_keyed_weights_match_jax():
    """A state with a per-step override loads and serves, and the step runs
    the override, as the JAX pipeline looks the step's name up first."""
    st = _override_state(SLICE)
    pt = _port(SLICE, st)
    assert sorted(pt.weights) == ["path_bayer", "step1_path_bayer"]
    x = np.random.default_rng(62).uniform(0, 1, (1, 32, 32, 1)).astype(
        np.float32)
    want = rj.Pipeline(SLICE)(jax.tree.map(jnp.asarray, st), jnp.asarray(x))
    with torch.no_grad():
        got = pt(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_step_key_is_used_before_op_key():
    st = _override_state(SLICE)
    plain = dict(st, weights={"path_bayer": st["weights"]["path_bayer"]})
    x = torch.from_numpy(np.random.default_rng(63).uniform(
        0, 1, (1, 32, 32, 1)).astype(np.float32))
    with torch.no_grad():
        with_step = _port(SLICE, st)(x)
        without = _port(SLICE, plain)(x)
    assert float((with_step - without).abs().max()) > 1e-2


def test_unknown_weights_name_raises():
    pt = rt.Pipeline(SLICE, device="cpu")
    for name in ("step7_path_bayer", "step2_path_bayer", "step2_laplacian",
                 "bm3d"):
        with pytest.raises(KeyError):
            pt.load_state({"weights": {name: {}}})


# ------------------------------------------------------------ median ties

@pytest.mark.parametrize("kind", ["grid", "saturated"])
def test_median_gradient_splits_ties_as_jax(kind):
    """Input gradient of sum(median * g) at r = 3 on tied values (a 1/8 grid,
    or runs of exact 0 and 1): the cotangent is shared equally among the
    taps equal to the median, as _median_taps does."""
    rng = np.random.default_rng(64)
    shape = (1, 16, 16, 3)
    x = (np.round(rng.uniform(0.25, 0.75, shape) * 8) / 8 if kind == "grid"
         else _saturated(shape, 65)).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    p = np.full((1, 1), 0.3, np.float32)
    value, vjp = jax.vjp(lambda v: jdenoise._median_jnp(v, p), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = km.median_plain(xt, torch.from_numpy(p))
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(vjp(g)[0]),
                               atol=1e-5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(value),
                               atol=1e-6)
    with torch.no_grad():
        assert torch.equal(out, km.median_plain(xt, torch.from_numpy(p)))


# ------------------------------------------------------------ clip at a bound

def test_clip_gradient_at_bounds_is_jnp_clip():
    v = np.asarray([-0.5, 0.0, 0.5, 1.0, 1.5], np.float32)
    for lo, hi in ((0.0, 1.0), (0.0, None), (None, 1.0)):
        want = jax.grad(lambda a: jnp.sum(jnp.clip(a, lo, hi)))(jnp.asarray(v))
        xt = torch.from_numpy(v).requires_grad_()
        clip(xt, lo, hi).sum().backward()
        np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want))


@pytest.mark.parametrize("op,value,expected", [
    ("gamma", 1.0, 0.5), ("wb_manual", 0.0, 1.25)])
def test_op_gradient_at_a_bound(op, value, expected):
    """gamma clips to [1e-8, 1] and wb_manual x * 2.5 to [0, 1]: at the
    bound both pass half the gradient."""
    n_params = {"gamma": 1, "wb_manual": 3}[op]
    x = np.full((1, 2, 2, 3), value, np.float32)
    p = np.full((1, n_params), 0.5, np.float32)
    want = jax.grad(lambda v: jnp.sum(getattr(jcolor, op)(v, p)))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    getattr(color, op)(xt, torch.from_numpy(p)).sum().backward()
    np.testing.assert_allclose(np.asarray(want), expected)
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", [
    FLAGSHIP, SLICE, SLICE2,
    *(a.replace("Bayer_01", "Bayer_02") for a in (FLAGSHIP, SLICE))])
def test_pipeline_gradients_on_saturated_mosaic_match_jax(arch):
    """Logit and input gradients of sum(y * g) on a mosaic with patches of
    exact 0 and 1.  Where the Bayer step is skip (02), the patches reach
    Malvar's clip at its bounds, then the clips after it; behind
    Path-Restore (01) they are no longer exact.  (Slice 2 with skip is left
    out: there JAX's tie-normalised median sum rounds ties of 1.0 to
    1.0000001 or 0.99999994 by its order of summation, and the clip after
    it passes 0 or 1 accordingly.)"""
    pj = rj.Pipeline(arch)
    st = pj.init(jax.random.PRNGKey(0))
    pt = _port(arch, _to_numpy(st))
    # 4x4 blocks, so that whole patches are exactly 0 or 1
    x = np.repeat(np.repeat(_saturated((1, 8, 8, 1), 66), 4, 1), 4, 2)
    g = np.random.default_rng(67).standard_normal((1, 32, 32, 3)).astype(
        np.float32)

    def loss(logits, v):
        return jnp.sum(pj(dict(st, logits=logits), v) * g)

    want_logits, want_x = jax.grad(loss, argnums=(0, 1))(
        st["logits"], jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    (pt(xt) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_x), atol=1e-4)
    assert sorted(want_logits) == sorted(pt.logits)
    for name, want in want_logits.items():
        # the median's logit sets only its radius, a floor: JAX gives 0,
        # autograd no gradient at all
        got = pt.logits[name].grad
        got = torch.zeros_like(pt.logits[name]) if got is None else got
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   err_msg=name)

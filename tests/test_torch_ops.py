"""The port's primitives, demosaics, colour and tone ops, conditional ops,
SRCNN nets and Path-Restore against the JAX package, on the same numpy
inputs and weights."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reconfigisp_tpu import registry as jreg
from reconfigisp_tpu.ops import cnn as jcnn
from reconfigisp_tpu.ops import color as jcolor
from reconfigisp_tpu.ops import conditional as jconditional
from reconfigisp_tpu.ops import demosaic as jdemosaic
from reconfigisp_tpu.ops import nn as jnn
from reconfigisp_tpu.ops import tone as jtone
from reconfigisp_tpu.utils.checkpoint import load_network as jload_network

from reconfigisp_tpu_torch import precision, registry
from reconfigisp_tpu_torch.convert import weights_from_jax
from reconfigisp_tpu_torch.ops import cnn, color, conditional, demosaic, nn, tone
from reconfigisp_tpu_torch.utils.checkpoint import load_network

CKPT = str(Path(__file__).resolve().parents[1] / "experiments" / "proxies"
           / "default.ckpt")


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


# ------------------------------------------------------------- primitives

_LAYOUT_CASES = {
    "bayer_to_rggb": (lambda r: r.uniform(0, 1, (2, 8, 12, 1)),
                      jnn.bayer_to_rggb, nn.bayer_to_rggb),
    "rggb_to_bayer": (lambda r: r.uniform(0, 1, (2, 4, 6, 4)),
                      jnn.rggb_to_bayer, nn.rggb_to_bayer),
    "pixel_shuffle": (lambda r: r.uniform(0, 1, (2, 4, 6, 12)),
                      lambda x: jnn.pixel_shuffle(x, 2),
                      lambda x: nn.pixel_shuffle(x, 2)),
    "broadcast_params": (lambda r: r.uniform(0, 1, (2, 5)),
                         lambda p: jnn.broadcast_params(p, 3, 4),
                         lambda p: nn.broadcast_params(p, 3, 4)),
}


@pytest.mark.parametrize("case", sorted(_LAYOUT_CASES))
def test_layout_ops_exact(case):
    make, jfn, tfn = _LAYOUT_CASES[case]
    x = make(np.random.default_rng(1)).astype(np.float32)
    np.testing.assert_array_equal(_np(tfn(torch.from_numpy(x))),
                                  _np(jfn(jnp.asarray(x))))


def test_pack_roundtrip_exact():
    x = torch.from_numpy(np.random.default_rng(2).uniform(
        0, 1, (2, 8, 12, 1)).astype(np.float32))
    assert torch.equal(nn.rggb_to_bayer(nn.bayer_to_rggb(x)), x)


def test_conv2d_matches_jax():
    r = np.random.default_rng(3)
    x = r.standard_normal((2, 10, 12, 5)).astype(np.float32)
    w = r.standard_normal((3, 3, 5, 7)).astype(np.float32)
    b = r.standard_normal((7,)).astype(np.float32)
    ref = jnn.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    out = nn.conv2d(*(torch.from_numpy(a) for a in (x, w, b)))
    np.testing.assert_allclose(_np(out), _np(ref), atol=1e-4)


def test_init_conv_bounds_and_generator():
    """torch-default bounds sqrt(1/fan_in); the draw follows the generator."""
    make = lambda seed: cnn.path14_bayer(torch.Generator().manual_seed(seed))
    a, b, c = make(0), make(0), make(1)
    bound = (1.0 / (3 * 3 * 64)) ** 0.5
    w = a.blocks[0].conv1.weight.detach()
    assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.9 * bound
    assert torch.equal(a.conv_first.weight, b.conv_first.weight)
    assert not torch.equal(a.conv_first.weight, c.conv_first.weight)


# ------------------------------------------------------------- demosaic

@pytest.mark.parametrize("name", ["nearest", "bilinear", "malvar"])
def test_demosaic_matches_jax(name):
    x = np.random.default_rng(4).uniform(0, 1, (2, 16, 20, 1)).astype(np.float32)
    ref = getattr(jdemosaic, f"demosaic_{name}")(jnp.asarray(x))
    out = getattr(demosaic, f"demosaic_{name}")(torch.from_numpy(x))
    np.testing.assert_allclose(_np(out), _np(ref), atol=1e-6)


# ------------------------------------------------------------- colour

_COLOR = {"gamma": 1, "grayworld": 0, "wb_manual": 3, "wb_whiteworld": 1,
          "wb_quadratic": 30, "skip": 0}


@pytest.mark.parametrize("name", sorted(_COLOR))
def test_color_matches_jax(name):
    r = np.random.default_rng(5)
    x = r.uniform(0.05, 0.95, (2, 12, 10, 3)).astype(np.float32)
    p = r.uniform(0, 1, (2, _COLOR[name])).astype(np.float32)
    ref = getattr(jcolor, name)(jnp.asarray(x), jnp.asarray(p))
    out = getattr(color, name)(torch.from_numpy(x), torch.from_numpy(p))
    np.testing.assert_allclose(_np(out), _np(ref), atol=1e-6)


# ------------------------------------------------------------- tone

_TONE = {"gtm_manual": 3, "tone_reinhard": 2, "tone_crysis": 1,
         "tone_filmic": 2}


@pytest.mark.parametrize("name", sorted(_TONE))
def test_tone_matches_jax(name):
    r = np.random.default_rng(8)
    x = r.uniform(0.0, 1.0, (2, 12, 10, 3)).astype(np.float32)
    p = r.uniform(0, 1, (2, _TONE[name])).astype(np.float32)
    ref = getattr(jtone, name)(jnp.asarray(x), jnp.asarray(p))
    out = getattr(tone, name)(torch.from_numpy(x), torch.from_numpy(p))
    np.testing.assert_allclose(_np(out), _np(ref), atol=1e-5)


# ------------------------------------------------------------- conditional

def test_channel_histograms_exact():
    x = np.random.default_rng(9).uniform(0, 1, (2, 12, 10, 3)).astype(
        np.float32)
    x[0, 0, 0] = [0.0, 1.0, 0.999]   # the clipped edge bins
    np.testing.assert_array_equal(
        _np(conditional.channel_histograms(torch.from_numpy(x), 8)),
        _np(jconditional._channel_histograms(jnp.asarray(x), 8)))


@pytest.mark.parametrize("name,n_glob", [("conditional_gamma", 1),
                                         ("conditional_wb_manual", 3),
                                         ("conditional_wb_quadratic", 30)])
def test_conditional_matches_jax(name, n_glob):
    """The FC net on the counts, then the base op; the matmuls sum 24 and 16
    terms in another order: 1e-5."""
    r = np.random.default_rng(10)
    x = r.uniform(0.05, 0.95, (2, 12, 10, 3)).astype(np.float32)
    total = jconditional.conditional_n_params((24, 16), n_glob)
    assert conditional.conditional_n_params((24, 16), n_glob) == total
    flat = (0.01 * r.standard_normal(total)).astype(np.float32)
    ref = getattr(jconditional, name)(jnp.asarray(x), jnp.asarray(flat))
    out = getattr(conditional, name)(torch.from_numpy(x),
                                     torch.from_numpy(flat))
    np.testing.assert_allclose(_np(out), _np(ref), atol=1e-5)


# ------------------------------------------------------------- SRCNN

def _srcnn_res_pair(n_params):
    jw = jcnn.init_srcnn_res(jax.random.PRNGKey(n_params), n_params)
    net = cnn.SRCNNRes(n_params, torch.Generator().manual_seed(0))
    net.load_state_dict(weights_from_jax(jax.tree.map(np.asarray, jw)))
    return jw, net


@pytest.mark.parametrize("n_params", [0, 1, 3, 5])
def test_srcnn_res_matches_jax(n_params):
    """Params zero-padded to MAX_PROXY_PARAMS; 9x9 and 5x5 'same' convs."""
    jw, net = _srcnn_res_pair(n_params)
    r = np.random.default_rng(11)
    x = r.uniform(0, 1, (2, 20, 16, 3)).astype(np.float32)
    p = r.uniform(0, 1, (2, n_params)).astype(np.float32) if n_params else None
    ref = jcnn.apply_srcnn_res(jw, jnp.asarray(x),
                               None if p is None else jnp.asarray(p))
    with torch.no_grad():
        out = cnn.apply_srcnn_res(net, torch.from_numpy(x),
                                  None if p is None else torch.from_numpy(p))
    assert out.shape == (2, 20, 16, 3)
    np.testing.assert_allclose(_np(out), _np(ref), atol=1e-4)


def test_srcnn_res_zeroes_unused_conditioning():
    net = cnn.SRCNNRes(2, torch.Generator().manual_seed(0))
    w = net.conv1.weight.detach()
    assert cnn.MAX_PROXY_PARAMS == jcnn.MAX_PROXY_PARAMS == 5
    assert w.shape == (64, 17, 9, 9)
    assert bool((w[:, 14:] == 0).all()) and bool((w[:, :14] != 0).any())


def test_srcnn_demosaic_matches_jax():
    jw = jcnn.init_srcnn_demosaic(jax.random.PRNGKey(3), 0)
    net = cnn.SRCNNDemosaic(torch.Generator().manual_seed(0))
    net.load_state_dict(weights_from_jax(jax.tree.map(np.asarray, jw)))
    x = np.random.default_rng(12).uniform(0, 1, (2, 16, 20, 1)).astype(
        np.float32)
    ref = jcnn.apply_srcnn_demosaic(jw, jnp.asarray(x))
    with torch.no_grad():
        out = cnn.apply_srcnn_demosaic(net, torch.from_numpy(x))
    assert out.shape == (2, 16, 20, 3)
    np.testing.assert_allclose(_np(out), _np(ref), atol=1e-4)


@pytest.mark.parametrize("net_name", ["srcnn_res", "srcnn_demosaic"])
def test_bf16_storage_keeps_each_conv_padding(net_name):
    """The bf16 path pads each conv by its own kernel (9x9, 5x5, 1x1)."""
    gen = torch.Generator().manual_seed(0)
    r = np.random.default_rng(13)
    if net_name == "srcnn_res":
        net, c = cnn.SRCNNRes(1, gen), 3
        run = lambda x: cnn.apply_srcnn_res(net, x, torch.full((1, 1), 0.5))
    else:
        net, c = cnn.SRCNNDemosaic(gen), 1
        run = lambda x: cnn.apply_srcnn_demosaic(net, x)
    x = torch.from_numpy(r.uniform(0, 1, (1, 16, 16, c)).astype(np.float32))
    with torch.no_grad():
        ref = run(x)
        with precision.cnn_storage("bf16"):
            out = run(x)
    assert out.shape == ref.shape == (1, 16, 16, 3)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(_np(out), _np(ref), atol=5e-2)


# ------------------------------------------------------------- Path-Restore

_PATH = {
    "bayer": (jcnn.init_path14_bayer, jcnn.apply_path14_bayer,
              cnn.path14_bayer, cnn.apply_path14_bayer, 1),
    "bgr": (jcnn.init_path14_bgr, jcnn.apply_path14_bgr,
            cnn.path14_bgr, cnn.apply_path14_bgr, 3),
}


def _path_pair(form):
    jinit, japply, tinit, tapply, c = _PATH[form]
    jw = jinit(jax.random.PRNGKey(0))
    net = tinit(torch.Generator().manual_seed(0))
    net.load_state_dict(weights_from_jax(jax.tree.map(np.asarray, jw)))
    return jw, japply, net, tapply, c


@pytest.mark.parametrize("form", ["bayer", "bgr"])
def test_path_restore_matches_jax(form):
    """64-channel stack; sums run in another order: atol 1e-4."""
    jw, japply, net, tapply, c = _path_pair(form)
    x = np.random.default_rng(6).uniform(0, 1, (2, 32, 32, c)).astype(np.float32)
    ref = japply(jw, jnp.asarray(x))
    with torch.no_grad():
        out = tapply(net, torch.from_numpy(x))
    assert out.shape == (2, 32, 32, c)
    np.testing.assert_allclose(_np(out), _np(ref), atol=1e-4)


def test_bf16_storage_runs_convs_in_bf16():
    """bf16 storage keeps the interface dtype and stays near the f32 result
    (bf16 has 8 mantissa bits: 5e-2 over 14 layers)."""
    _, _, net, tapply, _ = _path_pair("bayer")
    x = torch.from_numpy(np.random.default_rng(7).uniform(
        0, 1, (1, 16, 16, 1)).astype(np.float32))
    seen = []
    hook = net.blocks[0].register_forward_hook(
        lambda m, i, o: seen.append(o.dtype))
    with torch.no_grad():
        ref = tapply(net, x)
        with precision.cnn_storage("bf16"):
            out = tapply(net, x)
    hook.remove()
    assert seen == [torch.float32, torch.bfloat16]
    assert out.dtype == torch.float32
    assert precision.cnn_storage_dtype() == torch.float32
    np.testing.assert_allclose(_np(out), _np(ref), atol=5e-2)


# ------------------------------------------------------------- registry, ckpt

@pytest.mark.parametrize("domain", ["bayer", "demosaic", "srgb"])
def test_pools_match_jax(domain):
    """Same names, indices, parameter counts, init logits and kinds."""
    jpool, tpool = jreg.pool(domain), registry.pool(domain)
    assert [s.name for s in tpool] == [s.name for s in jpool]
    assert [s.n_params for s in tpool] == [s.n_params for s in jpool]
    for js, ts in zip(jpool, tpool):
        np.testing.assert_allclose(ts.init_logits, js.init_logits)
        assert registry.get_op(domain, jreg.op_index(domain, js.name)) is ts
        assert ts.conditional == js.conditional
        assert ts.proxy_only == js.proxy_only
        assert (ts.proxy_apply is None) == (js.proxy_apply is None)
        # the port's own H100 table, not the JAX package's TPU figures
        assert ts.latency == registry.LATENCY_MS_PER_MP[ts.name] > 0


def test_load_network_matches_jax_loader():
    ours, theirs = load_network(CKPT), jload_network(CKPT)
    assert sorted(ours) == sorted(theirs)
    a = jax.tree.leaves(ours["path_bayer"])
    b = jax.tree.leaves(theirs["path_bayer"])
    assert len(a) == len(b) == 2 * 14
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)

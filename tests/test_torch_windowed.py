"""The median and fast-NLM plain PyTorch forms against the JAX forms: the jnp
reference forms, the op-level dispatch and the Pallas kernels in interpret
mode; and the CPU routing of their kernel wrappers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reconfigisp_tpu.ops import denoise as jdenoise
from reconfigisp_tpu.ops.pallas_kernels import fastnlm_pallas, median_pallas

from reconfigisp_tpu_torch import registry
from reconfigisp_tpu_torch.ops import denoise
from reconfigisp_tpu_torch.ops.kernels import fastnlm as kf
from reconfigisp_tpu_torch.ops.kernels import median as km

# jitted so that one compile per shape serves every radius
_MEDIAN_REFS = {"jnp": jax.jit(jdenoise._median_jnp),
                "op_dispatch": jax.jit(jdenoise.median)}
_NLM_REFS = {"jnp": jax.jit(jdenoise._fastnlm_jnp),
             "op_dispatch": jax.jit(jdenoise.fastnlm)}


def _image(shape, seed, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _size01(radius):
    """A [0,1] parameter whose mapped radius is `radius`."""
    return (radius - 0.5) / 7.0


# ------------------------------------------------------------------ median

@pytest.mark.parametrize("ref", sorted(_MEDIAN_REFS))
@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("radius", range(1, 8))
def test_median_plain_equals_jax(radius, c, ref):
    """Both select the exact middle tap: bit-identical.  70 rows: one full
    64-row strip and a remainder."""
    x = _image((2, 70, 24, c), seed=41)
    # the radius comes from image 0; image 1's parameter is ignored
    p = np.asarray([[_size01(radius)], [0.99]], np.float32)
    want = np.asarray(_MEDIAN_REFS[ref](jnp.asarray(x), jnp.asarray(p)))
    got = km.median_plain(torch.from_numpy(x), torch.from_numpy(p))
    np.testing.assert_array_equal(got.numpy(), want)


def test_median_plain_matches_pallas_interpret():
    """The TPU kernel bisects values 14 times: within 255/2^14 on 0..255."""
    x = _image((2, 32, 32, 3), seed=42, lo=0.05, hi=0.95)
    p = np.asarray([[0.3], [0.3]], np.float32)
    want = median_pallas(jnp.asarray(x), jnp.asarray(p), strip=16,
                         interpret=True)
    got = km.median_plain(torch.from_numpy(x), torch.from_numpy(p))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_median_removes_impulse():
    x = np.full((1, 16, 16, 1), 0.5, np.float32)
    x[0, 8, 8, 0] = 1.0
    out = denoise.median(torch.from_numpy(x), torch.zeros((1, 1)))
    assert torch.equal(out, torch.full_like(out, 0.5))


# ------------------------------------------------------------------ fast NLM

# rows [block01, search01, decay01]: per-image search radii 1, 4 and 7 and
# distinct decays; the block radius (from row 0) is the case
def _nlm_params(block):
    return np.asarray([[_size01(block), _size01(1), 0.1],
                       [0.0, _size01(4), 0.5],
                       [0.0, _size01(7), 0.9]], np.float32)


@pytest.mark.parametrize("ref", sorted(_NLM_REFS))
@pytest.mark.parametrize("block", [1, 3, 7])
def test_fastnlm_plain_matches_jax_whole_frame(block, ref):
    """Same function over the whole frame, border rule included; the sums
    run in the same order and only exp differs: 2e-5."""
    x = _image((3, 24, 40, 3), seed=43)
    p = _nlm_params(block)
    want = np.asarray(_NLM_REFS[ref](jnp.asarray(x), jnp.asarray(p)))
    got = kf.fastnlm_plain(torch.from_numpy(x), torch.from_numpy(p))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_fastnlm_plain_one_channel():
    x = _image((3, 24, 16, 1), seed=44)
    p = _nlm_params(2)
    want = np.asarray(_NLM_REFS["jnp"](jnp.asarray(x), jnp.asarray(p)))
    got = kf.fastnlm_plain(torch.from_numpy(x), torch.from_numpy(p))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_fastnlm_plain_vs_pallas_interpret_interior_and_border():
    """The Pallas kernel boxes differences of the reflect-padded image, the
    reference form (and the port) the reflect-padded difference field: the
    interior agrees at 2e-5, the border does not."""
    x = _image((2, 32, 32, 3), seed=45, lo=0.05, hi=0.95)
    p = np.asarray([[0.15, 0.3, 0.3], [0.15, 0.6, 0.5]], np.float32)
    want = np.asarray(fastnlm_pallas(jnp.asarray(x), jnp.asarray(p),
                                     strip=16, interpret=True))
    got = kf.fastnlm_plain(torch.from_numpy(x), torch.from_numpy(p)).numpy()
    m = 10
    np.testing.assert_allclose(got[:, m:-m, m:-m], want[:, m:-m, m:-m],
                               atol=2e-5)
    assert np.abs(got - want).max() > 1e-3


def test_fastnlm_denoises():
    rng = np.random.default_rng(46)
    clean = np.full((1, 16, 16, 1), 0.5, np.float32)
    noisy = np.clip(clean + rng.normal(0, 0.08, clean.shape), 0, 1).astype(
        np.float32)
    out = denoise.fastnlm(torch.from_numpy(noisy),
                          torch.tensor([[0.1, 0.5, 0.3]])).numpy()
    assert np.abs(out - clean).mean() < np.abs(noisy - clean).mean() * 0.6


# ------------------------------------------------------------------ routing

_KERNELS = {"median": (km, denoise.median, km.median_plain, 1),
            "fastnlm": (kf, denoise.fastnlm, kf.fastnlm_plain, 3)}


@pytest.mark.parametrize("name", sorted(_KERNELS))
def test_cpu_dispatch_uses_plain_form(name):
    """A CPU tensor takes the plain form and launches no kernel."""
    mod, op, plain, n_params = _KERNELS[name]
    x = torch.from_numpy(_image((2, 16, 24, 3), seed=47))
    p = torch.full((2, n_params), 0.4)
    before = mod.launches
    out = op(x, p)
    assert mod.launches == before
    assert torch.equal(out, plain(x, p))


@pytest.mark.parametrize("name", sorted(_KERNELS))
def test_other_devices_raise(name):
    _, op, _, n_params = _KERNELS[name]
    with pytest.raises(ValueError, match="cuda or cpu"):
        op(torch.empty((1, 16, 16, 3), device="meta"),
           torch.empty((1, n_params), device="meta"))


@pytest.mark.parametrize("idx,name,n_params", [(8, "median", 1),
                                               (9, "fastnlm", 3)])
def test_registry_routes_ops_to_kernel_modules(idx, name, n_params):
    spec = registry.get_op("srgb", idx)
    assert (spec.name, spec.n_params) == (name, n_params)
    mod, op, plain, _ = _KERNELS[name]
    assert op is getattr(mod, name)
    x = torch.from_numpy(_image((1, 16, 16, 3), seed=48))
    p = torch.full((1, n_params), 0.3)
    assert torch.equal(spec.apply(x, p, None), plain(x, p))

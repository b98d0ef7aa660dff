"""The fast-NLM plain PyTorch form against the JAX forms (the jnp
reference form, the op-level dispatch and the Pallas kernel in interpret
mode), the arithmetic of csrc/fastnlm.cu emulated on the CPU, and the
capture-safe route of the plain form against its host-read route."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reconfigisp_tpu.ops import denoise as jdenoise
from reconfigisp_tpu.ops.pallas_kernels import fastnlm_pallas

from reconfigisp_tpu_torch.ops import denoise
from reconfigisp_tpu_torch.ops.kernels import fastnlm as kf

from test_torch_windowed_bilateral import assert_routes_agree
from torch_one_thread import one_thread  # noqa: F401  (autouse)

# jitted so that one compile per shape serves every block radius
_NLM_REFS = {"jnp": jax.jit(jdenoise._fastnlm_jnp),
             "op_dispatch": jax.jit(jdenoise.fastnlm)}


def _image(shape, seed, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _size01(radius):
    """A [0,1] parameter whose mapped radius is `radius`."""
    return (radius - 0.5) / 7.0



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


def _window_sums(v, n, b, dim):
    """out[m] = v[m] + ... + v[m + 2b] for m < n along dim, in the order of
    csrc/fastnlm.cu's window_sums: groups of up to 2b+1 windows share a
    pivot p, and each window is a suffix sum of v[m .. p-1] plus a prefix
    sum of v[p .. m+2b]."""
    L = 2 * b + 1
    take = lambda i: v.narrow(dim, i, 1)
    out = [None] * n
    for g in range(0, n, L):
        p = min(g + L, n) - 1
        for i in range(1, L):
            m = p - i
            if m >= g:
                out[m] = take(m) if i == 1 else take(m) + out[m + 1]
        pre = take(p)
        for i in range(L):
            if i > 0:
                pre = pre + take(p + i)
            m = p + i - (L - 1)
            if g <= m < p:
                out[m] = out[m] + pre
        out[p] = pre
    return torch.cat(out, dim)


def _box_sums_kernel_order(d, b):
    """The (2b+1)^2 box sum of NCHW d with reflect padding of d itself, as the
    kernel forms it: horizontal sums for runs of 16 columns (8 for one
    channel), then vertical sums for runs of 4 rows, each run's windows by
    _window_sums."""
    h, w = d.shape[2:]
    run = 8 if d.shape[1] == 1 else 16
    fn = torch.nn.functional
    cols = fn.pad(d, (b, b, 0, 0), mode="reflect")
    cols = fn.pad(cols, (0, -w % run))
    rows = torch.cat([_window_sums(cols[..., x0:x0 + run + 2 * b], run, b, 3)
                      for x0 in range(0, w, run)], 3)[..., :w]
    rows = fn.pad(rows, (0, 0, b, b), mode="reflect")
    rows = fn.pad(rows, (0, 0, 0, -h % 4))
    return torch.cat([_window_sums(rows[:, :, y0:y0 + 4 + 2 * b], 4, b, 2)
                      for y0 in range(0, h, 4)], 2)[:, :, :h]


def _nlm_kernel_arithmetic(x, params):
    """csrc/fastnlm.cu's arithmetic in plain PyTorch: each offset's box sum
    in the kernel's order, and the weight is exp2 of it times one factor
    -log2(e) / ((2b+1)^2 h^2) per image."""
    n, h, w, c = x.shape
    b = int(kf.size01_to_radius(params[0, 0]))
    search = kf.size01_to_radius(params[:, 1])[:, None, None, None]
    hd = 1.0 + 99.0 * params[:, 2]
    k = float(2 * b + 1)
    neg_scale = (-1.4426950408889634 * (1.0 / (hd * hd)) / (k * k))
    neg_scale = neg_scale[:, None, None, None]
    x255 = (x * 255.0).permute(0, 3, 1, 2)
    padded = torch.nn.functional.pad(x255, (kf.MAX_R,) * 4, mode="reflect")
    s_max = int(search.max())
    num = torch.zeros_like(x255)
    den = torch.zeros_like(x255)
    for dx in range(-s_max, s_max + 1):
        for dy in range(-s_max, s_max + 1):
            tap = padded[:, :, kf.MAX_R + dy:kf.MAX_R + dy + h,
                         kf.MAX_R + dx:kf.MAX_R + dx + w]
            box = _box_sums_kernel_order((tap - x255) ** 2, b)
            include = (max(abs(dy), abs(dx)) <= search).to(x.dtype)
            wgt = include * torch.exp2(box * neg_scale)
            num = num + wgt * tap
            den = den + wgt
    out = (num / torch.clamp(den, min=1e-8) / 255.0).permute(0, 2, 3, 1)
    return torch.clamp(out, 0.0, 1.0)


def test_window_sums_are_the_direct_sums():
    """The pivot order gives every window's own 2b+1 terms: against a direct
    sum in float64, for each radius and a run length that no group fills."""
    v = torch.from_numpy(np.random.default_rng(50).uniform(0, 65025, (3, 30)))
    for b in range(1, 8):
        for n in (4, 8, 16):
            got = _window_sums(v[:, :n + 2 * b], n, b, 1)
            want = torch.stack([v[:, m:m + 2 * b + 1].sum(1)
                                for m in range(n)], 1)
            torch.testing.assert_close(got, want, rtol=1e-12, atol=0)


def _nlm_test_image(kind, c):
    """Uniform noise, or a dark-bright step with a little noise: the step's
    D reaches ~255^2 right beside values near 0."""
    rng = np.random.default_rng(49)
    shape = (7, 20, 28, c)
    if kind == "noise":
        return rng.uniform(0, 1, shape).astype(np.float32)
    step = np.where(np.arange(shape[2]) < 13, 0.02, 0.98)[None, None, :, None]
    return np.clip(step + rng.uniform(-0.02, 0.02, shape), 0, 1).astype(
        np.float32)


@pytest.mark.parametrize("kind", ["noise", "edge"])
@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("block", range(1, 8))
def test_fastnlm_kernel_arithmetic_within_tolerance(block, c, kind):
    """The CUDA kernel's order of sums, folded scale and exp2 against the
    plain form, before any card: within the 5e-5 that the card holds it to.
    Per-image search radii 1-7 and decays 0.05-0.83 (h = 5.95 to 83.2)."""
    x = torch.from_numpy(_nlm_test_image(kind, c))
    p = torch.tensor([[_size01(block) if i == 0 else 0.0, _size01(i + 1),
                       0.05 + 0.13 * i] for i in range(7)], dtype=torch.float32)
    got = _nlm_kernel_arithmetic(x, p)
    want = kf.fastnlm_plain(x, p)
    assert float((got - want).abs().max()) <= 5e-5


def test_fastnlm_denoises():
    rng = np.random.default_rng(46)
    clean = np.full((1, 16, 16, 1), 0.5, np.float32)
    noisy = np.clip(clean + rng.normal(0, 0.08, clean.shape), 0, 1).astype(
        np.float32)
    out = denoise.fastnlm(torch.from_numpy(noisy),
                          torch.tensor([[0.1, 0.5, 0.3]])).numpy()
    assert np.abs(out - clean).mean() < np.abs(noisy - clean).mean() * 0.6



# ------------------------------------------------- capture-safe route

@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("block", range(1, 8))
def test_fastnlm_capture_safe_route_equals_host_route(block, c):
    """The block radius and the search offsets kept on the device against
    the radii read on the host.  Per-image search radii 1, 3 and 5: the
    host-read route stops at 5, the capture-safe one runs to MAX_R, and
    each image masks at its own radius."""
    x = torch.from_numpy(_image((3, 20, 24, c), seed=60))
    p = torch.tensor([[_size01(block), _size01(s), 0.1 + 0.3 * i]
                      for i, s in enumerate((1, 3, 5))])
    assert_routes_agree(kf.fastnlm_plain, x, p)

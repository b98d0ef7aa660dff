"""The arithmetic of csrc/bilateral.cu emulated on the CPU against the
bilateral's plain PyTorch form, and the capture-safe route of the plain
form against its host-read route.  `assert_routes_agree` serves the three
windowed ops' route tests."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from reconfigisp_tpu_torch.ops.kernels import bilateral as kb
from torch_one_thread import one_thread  # noqa: F401  (autouse)


def _image(shape, seed, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _size01(radius):
    """A [0,1] parameter whose mapped radius is `radius`."""
    return (radius - 0.5) / 7.0



# ------------------------------------------------------------------ bilateral

def _bilateral_kernel_arithmetic(x, params):
    """csrc/bilateral.cu's arithmetic in plain PyTorch: every value staged
    on the 0..255 scale times s = sqrt(kc), with kc and ks the two
    log2(e) / (2 sigma^2) of each image; per tap one weight
    exp2(fma(d, -d, -(dy^2 + dx^2) ks)) of the staged difference d, flushed
    to 0 below 2^-126 as ex2.approx.ftz does; num takes an FMA (emulated in
    float64, rounded once), den an add; each output sums dx outer and dy
    inner, as a thread's column of rows meets its taps, and is divided by s
    at the end."""
    n, h, w, c = x.shape
    radius = kb.size01_to_radius(params[:, 0])[:, None, None, None]
    sc = 1.0 + 99.0 * params[:, 1]
    ss = 1.0 + 99.0 * params[:, 2]
    log2e = torch.tensor(1.4426950408889634, dtype=torch.float32)
    scale = torch.sqrt(log2e * (0.5 / (sc * sc)))[:, None, None, None]
    ks = (log2e * (0.5 / (ss * ss)))[:, None, None, None]
    staged = x * 255.0 * scale
    padded = kb.pad_reflect(staged, kb.MAX_R)
    r_max = int(radius.max())
    num = torch.zeros_like(staged)
    den = torch.zeros_like(staged)
    fma = lambda a, b, acc: (a.double() * b.double() + acc.double()).float()
    for dx in range(-r_max, r_max + 1):
        for dy in range(-r_max, r_max + 1):
            tap = padded[:, kb.MAX_R + dy:kb.MAX_R + dy + h,
                         kb.MAX_R + dx:kb.MAX_R + dx + w, :]
            d = tap - staged
            arg = fma(d, -d, -float(dy * dy + dx * dx) * ks)
            wgt = torch.where(arg < -126.0, 0.0, torch.exp2(arg))
            wgt = wgt * (max(abs(dy), abs(dx)) <= radius).to(x.dtype)
            num = fma(wgt, tap, num)
            den = den + wgt
    out = num / torch.clamp(den, min=1e-8) / scale / 255.0
    return torch.clamp(out, 0.0, 1.0)


def _bilateral_test_image(kind, c):
    rng = np.random.default_rng(53)
    shape = (7, 20, 28, c)
    u = rng.uniform(0, 1, shape)
    if kind == "noise":
        x = u
    elif kind == "edge":
        x = np.where(np.arange(shape[2]) < 13, 0.02, 0.98)[:, None] + 0.01 * u
    else:                       # saturated: runs of exact 0.0 and 1.0
        x = np.clip(2 * u - 0.5, 0, 1)
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize("sigma01", [0.0, 0.05, 1.0])
@pytest.mark.parametrize("kind", ["noise", "edge", "saturated"])
@pytest.mark.parametrize("c", [1, 3])
def test_bilateral_kernel_arithmetic_within_tolerance(c, kind, sigma01):
    """The CUDA kernel's staged scale, single exp2 per tap and order of
    sums against the plain form, before any card: within the 2e-5 that the
    card holds it to.  Radii 1-7, one per image; sigma 1 (sigma01 = 0) gives
    the most peaked weights, sigma 100 (sigma01 = 1) the flattest."""
    x = _bilateral_test_image(kind, c)
    p = torch.tensor([[_size01(r), sigma01, sigma01] for r in range(1, 8)],
                     dtype=torch.float32)
    got = _bilateral_kernel_arithmetic(x, p)
    want = kb.bilateral_plain(x, p)
    assert float((got - want).abs().max()) <= 2e-5


def test_bilateral_rows_match_the_kernel_source():
    """BILATERAL_ROWS, by which tests/test_torch_cuda_build.py counts the
    MUFU.EX2 of each body, is the rows a thread owns in csrc/bilateral.cu."""
    src = (Path(kb.__file__).resolve().parents[2] / "csrc" / "bilateral.cu"
           ).read_text()
    assert re.search(r"constexpr int kRows = (\d+);", src)[1] == str(
        kb.BILATERAL_ROWS)



# ------------------------------------------------- capture-safe route

def assert_routes_agree(plain, x: torch.Tensor, p: torch.Tensor) -> None:
    """plain(x, p)'s capture-safe route (static=True, the window bounds
    kept on the device) against its host-read route: the value, the input
    gradient and the params gradient of one cotangent, bit for bit."""
    g = torch.from_numpy(np.random.default_rng(57).normal(
        size=x.shape).astype(np.float32))
    got = []
    for static in (False, True):
        xs, ps = x.clone().requires_grad_(), p.clone().requires_grad_()
        y = plain(xs, ps, static=static)
        grads = torch.autograd.grad(y, (xs, ps), g, allow_unused=True)
        got.append((y.detach(),) + grads)
    for name, a, b in zip(("value", "x gradient", "params gradient"), *got):
        assert (a is None) == (b is None), name
        assert a is None or torch.equal(a, b), (
            name, float((a - b).abs().max()))


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("radius", range(1, 8))
def test_bilateral_capture_safe_route_equals_host_route(radius, c):
    """Image 0 at `radius`, the others below it: the host-read route stops
    at the batch's largest radius, the capture-safe one runs to MAX_R."""
    x = torch.from_numpy(_image((3, 20, 24, c), seed=58))
    p = torch.tensor([[_size01(radius), 0.1, 0.2],
                      [_size01(max(1, radius - 2)), 0.3, 0.5],
                      [_size01(1), 0.9, 0.05]])
    assert_routes_agree(kb.bilateral_plain, x, p)

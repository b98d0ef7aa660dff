"""The algorithm of csrc/bilateral.cu's backward kernel, emulated on the CPU
in its order of sums, against torch.autograd.grad of bilateral_plain.

The kernel recomputes num and den in the plain form's order and arithmetic
(so y and the clip's mask at an exact bound are the plain form's), forms
per value A = g m / (255 den), and then, per offset d of the value's window
in the plain form's order, the centre's term at -d (its tap R(s - d)) and
the tap's term from each reflection preimage p of the value, R(p + d) = s,
four threads a value over quarters of the offsets, joined as ((q0 + q2) +
(q1 + q3)); the params' gradient sums t d^2 and t |d|^2 of the centre's
terms in float64.  The emulation does the same per image, with torch on
the CPU (whose y / 255 divides where the card multiplies by the
reciprocal, as the plain form does on each device).
"""

import numpy as np
import pytest
import torch

from reconfigisp_tpu_torch.ops.kernels import bilateral as kb

from torch_one_thread import one_thread  # noqa: F401  (autouse)

MAX_R = kb.MAX_R
QUARTERS = 4


def _size01(radius):
    return (radius - 0.5) / 7.0


def _preimages(q, o, n):
    """(index, valid) of the three candidates p with R(p + o) = q along one
    axis, in the kernel's order: q - o, then the reflections -q - o (q >= 1)
    and 2 (n - 1) - q - o (q <= n - 2)."""
    cands = [(q - o, torch.ones_like(q, dtype=torch.bool)),
             (-q - o, q >= 1), (2 * n - 2 - q - o, q <= n - 2)]
    return [(idx.clamp(0, n - 1), ok & (idx >= 0) & (idx < n))
            for idx, ok in cands]


def _emulate_backward(x, params, g):
    """(gx, gp) of sum(bilateral(x, params) * g) as the kernel forms them,
    and each params gradient with the terms of its sum taken by their
    magnitudes (the scale of that sum's rounding)."""
    n, h, w, c = x.shape
    gx = torch.empty_like(x)
    gp = torch.zeros(n, 3)
    gp_scale = torch.zeros(n, 3, dtype=torch.float64)
    rows = torch.arange(h)[:, None, None]
    cols = torch.arange(w)[None, :, None]
    chan = torch.arange(c)[None, None, :]
    for i in range(n):
        r = int(kb.size01_to_radius(params[i, 0]))
        sc = 1.0 + 99.0 * params[i, 1]
        ss = 1.0 + 99.0 * params[i, 2]
        kc, ks = 0.5 / sc ** 2, 0.5 / ss ** 2
        xs = x[i] * 255.0
        padded = kb.pad_reflect(xs[None], MAX_R)[0]
        offsets = [(dx, dy) for dx in range(-r, r + 1)
                   for dy in range(-r, r + 1)]
        space = [torch.exp(-(dx * dx + dy * dy) * ks) for dx, dy in offsets]

        def tap(dx, dy):
            return padded[MAX_R + dy:MAX_R + dy + h, MAX_R + dx:MAX_R + dx + w]

        def weight(k, d):
            return space[k] * torch.exp(-(d * d) * kc)

        # stats: num and den in the plain form's order
        num = torch.zeros_like(xs)
        den = torch.zeros_like(xs)
        for k, (dx, dy) in enumerate(offsets):
            t = tap(dx, dy)
            wgt = weight(k, t - xs)
            num = num + wgt * t
            den = den + wgt
        y = num / den
        out = y / 255.0
        m = torch.where((out > 0) & (out < 1), 1.0,
                        torch.where((out == 0) | (out == 1), 0.5, 0.0))
        a = ((g[i] * m) / 255.0) / den

        # the gather, a quarter of the offsets a thread
        ec = torch.zeros((), dtype=torch.float64)
        es, ec_abs, es_abs = ec.clone(), ec.clone(), ec.clone()
        chunk = -(-len(offsets) // QUARTERS)
        quarters = []
        for quarter in range(QUARTERS):
            acc = torch.zeros_like(xs)
            for k in range(quarter * chunk,
                           min((quarter + 1) * chunk, len(offsets))):
                dx, dy = offsets[k]
                u = tap(-dx, -dy)        # the centre's term at -d
                du = u - xs
                t = (a * (u - y)) * weight(k, du)
                acc = acc + ((2.0 * kc) * du) * t
                term_c = t.double() * (du * du).double()
                term_s = t.double() * float(dx * dx + dy * dy)
                ec, ec_abs = ec + term_c.sum(), ec_abs + term_c.abs().sum()
                es, es_abs = es + term_s.sum(), es_abs + term_s.abs().sum()
                for ri, rv in _preimages(rows, dy, h):   # the tap's terms
                    for ci, cv in _preimages(cols, dx, w):
                        dp = xs - xs[ri, ci, chan]
                        aw = a[ri, ci, chan] * weight(k, dp)
                        b = ((2.0 * kc) * dp) * (aw * (xs - y[ri, ci, chan]))
                        acc = acc + torch.where(rv & cv, aw - b, 0.0)
            quarters.append(acc)
        total = (quarters[0] + quarters[2]) + (quarters[1] + quarters[3])
        gx[i] = total * 255.0
        chain_c = 99.0 / float(sc) ** 3
        chain_s = 99.0 / float(ss) ** 3
        gp[i, 1], gp[i, 2] = float(ec * chain_c), float(es * chain_s)
        gp_scale[i, 1], gp_scale[i, 2] = ec_abs * chain_c, es_abs * chain_s
    return gx, gp, gp_scale


def _plain_grads(x, params, g):
    xs, ps = x.clone().requires_grad_(), params.clone().requires_grad_()
    return torch.autograd.grad(kb.bilateral_plain(xs, ps), (xs, ps), g)


def _case(shape, radius, seed, saturated=False):
    """Three images at radii `radius`, 1 + (radius + 2) % 7 and 7, each
    with its own sigma pair; with `saturated`, a patch of exact 1 and one of
    exact 0 in each."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, shape).astype(np.float32)
    if saturated:
        h, w = shape[1:3]
        x[:, :h // 2, :w // 2] = 1.0
        x[:, h // 2:, w // 2:] = 0.0
    radii = [radius, 1 + (radius + 2) % 7, 7]
    p = np.asarray([[_size01(r), 0.05 + 0.3 * i, 0.1 + 0.25 * i]
                    for i, r in enumerate(radii)], np.float32)[:shape[0]]
    g = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(p), torch.from_numpy(g)


def _assert_close_to_plain(got, want):
    """gx within 1e-5 of its largest reference value (sums in another
    order); each params gradient within 1e-5 of the sum of its terms'
    magnitudes: that sum over values and offsets cancels, so two float32
    evaluations of it differ by rounding of its terms, not of its value.
    The radius's gradient is an exact zero in both."""
    (gx, gp, gp_scale), (wx, wp) = got, want
    assert float((gx - wx).abs().max()) <= 1e-5 * float(wx.abs().max())
    assert bool(((gp - wp).abs().double() <= 1e-5 * gp_scale).all())
    assert torch.equal(gp[:, 0], torch.zeros_like(gp[:, 0]))
    assert torch.equal(wp[:, 0], torch.zeros_like(wp[:, 0]))


@pytest.mark.parametrize("kind", ["noise", "saturated"])
@pytest.mark.parametrize("frame", [(8, 9), (20, 17)], ids=["8x9", "20x17"])
@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("radius", range(1, 8))
def test_bilateral_backward_algorithm_matches_autograd(radius, c, frame, kind):
    """Radii 1-7 for the first image, and other radii for the two beside it
    in the batch; frames from 8 x 9 (just above MAX_R: every window reflects
    at both edges, and a value has up to nine preimages an offset) to
    20 x 17; the saturated patches put the clip's 1/2 tie where y is
    exactly 0 or 255."""
    x, p, g = _case((3, *frame, c), radius, seed=90 + radius,
                    saturated=kind == "saturated")
    _assert_close_to_plain(_emulate_backward(x, p, g), _plain_grads(x, p, g))


def test_frame_above_the_direct_rows():
    """A frame above _vjp.DIRECT_ROWS, which the CPU's backward takes by
    strips: the kernel takes it on the same path as any other."""
    x, p, g = _case((1, 644, 9, 1), 7, seed=97)
    assert x.shape[1] > kb._vjp.DIRECT_ROWS
    _assert_close_to_plain(_emulate_backward(x, p, g), _plain_grads(x, p, g))


def test_saturated_patch_takes_the_clip_tie():
    """Where y is exactly 0 or 255 the clip passes half the cotangent, in
    the emulation's mask as in the plain form's autograd."""
    x, p, g = _case((3, 24, 24, 1), 1, seed=98, saturated=True)
    xs = x.clone().requires_grad_()
    out = kb.bilateral_plain(xs, p)
    assert bool(((out == 0) | (out == 1)).any())
    _assert_close_to_plain(_emulate_backward(x, p, g), _plain_grads(x, p, g))

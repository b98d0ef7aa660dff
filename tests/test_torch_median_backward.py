"""The algorithm of csrc/median.cu's backward kernel, emulated on the CPU in
its order of sums, against torch.autograd.grad of median_plain.

The kernel's stats pass selects each value's window median m again
(exactly, as the forward does: tests/test_torch_windowed_median.py emulates
that selection, so kthvalue stands in for it here), counts the taps equal
to it under float == (c, with +0 and -0 tied) and forms A = g k / c, k the
clip's mask.  Its gather then takes, per offset d of the value's window in
row-major order, the share A_p of each reflection preimage p of the value,
R(p + d) = s, where x_s == m_p; four threads a value over quarters of the
offsets, joined as ((q0 + q2) + (q1 + q3)).  The emulation does the same
with torch on the CPU.  The plain form's autograd adds the same shares in
another order, so a value that takes one share gets it bit for bit, and
any other within the rounding of a float32 sum of its shares.
"""

import numpy as np
import pytest
import torch

from reconfigisp_tpu_torch.ops.kernels import _vjp
from reconfigisp_tpu_torch.ops.kernels import median as km

from torch_one_thread import one_thread  # noqa: F401  (autouse)

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
    """(gx, gp) of sum(median(x, params) * g) as the kernel forms them, each
    value's number of shares, the sum of their magnitudes, and each
    window's tie count c."""
    n, h, w, c = x.shape
    r = int(km.size01_to_radius(params[0, 0]))
    offsets = [(dy, dx) for dy in range(-r, r + 1) for dx in range(-r, r + 1)]
    padded = km.pad_reflect(x, r)
    taps = torch.stack([padded[:, r + dy:r + dy + h, r + dx:r + dx + w]
                        for dy, dx in offsets])

    # stats: the median, its ties, and A = g k / c
    m = torch.kthvalue(taps, len(offsets) // 2 + 1, dim=0).values
    count = (taps == m).sum(0)
    gk = torch.where((m > 0) & (m < 1), g,
                     torch.where((m == 0) | (m == 1), g * 0.5,
                                 torch.zeros_like(g)))
    a = gk / count.to(x.dtype)

    # the gather, a quarter of the offsets a thread
    rows = torch.arange(h)[:, None, None]
    cols = torch.arange(w)[None, :, None]
    chan = torch.arange(c)[None, None, :]
    shares = torch.zeros(x.shape, dtype=torch.int64)
    scale = torch.zeros_like(x)
    chunk = -(-len(offsets) // QUARTERS)
    quarters = []
    for quarter in range(QUARTERS):
        acc = torch.zeros_like(x)
        for dy, dx in offsets[quarter * chunk:(quarter + 1) * chunk]:
            for ri, rv in _preimages(rows, dy, h):
                for ci, cv in _preimages(cols, dx, w):
                    take = rv & cv & (x == m[:, ri, ci, chan])
                    share = torch.where(take, a[:, ri, ci, chan], 0.0)
                    acc = acc + share
                    shares += take
                    scale += share.abs()
        quarters.append(acc)
    gx = (quarters[0] + quarters[2]) + (quarters[1] + quarters[3])
    return gx, torch.zeros_like(params), shares, scale, count


def _plain_grads(x, params, g):
    xs = x.clone().requires_grad_()
    ps = params.clone().requires_grad_()
    return torch.autograd.grad(km.median_plain(xs, ps), (xs, ps), g,
                               allow_unused=True)


def _assert_close_to_plain(got, want):
    """A value's gradient is the sum of its shares: the emulation's and the
    plain form's autograd add them in different orders, each within
    (k - 1) 2^-24 of the sum of the k shares' magnitudes, so they differ by
    at most (k - 1) 2^-23 of it, and not at all where a value takes one
    share or none.  No gradient reaches the params: the emulation gives an
    exact 0, as the kernel, and autograd none."""
    (gx, gp, shares, scale, _), (wx, wp) = got, want
    bound = (shares - 1).clamp(min=0).to(scale.dtype) * 2.0 ** -23 * scale
    assert bool(((gx - wx).abs() <= bound).all())
    single = shares <= 1
    assert torch.equal(gx[single], wx[single])
    assert wp is None and torch.equal(gp, torch.zeros_like(gp))


def _case(shape, radius, seed, kind):
    """Two images at radius `radius` (the batch's, from image 0's params;
    image 1's params are another radius and go unread).  kind: "noise",
    uniform; "saturated", noise with a patch of exact 1 and one of exact 0;
    "quantized", multiples of 1/8 in [0, 1], so that windows tie in runs
    and at exact 0 and 1; "signed_zero", the same with each 0 given a
    random sign."""
    rng = np.random.default_rng(seed)
    h, w = shape[1:3]
    if kind in ("quantized", "signed_zero"):
        x = (rng.integers(0, 9, shape) / 8.0).astype(np.float32)
        if kind == "signed_zero":
            x[(x == 0) & (rng.uniform(size=shape) < 0.5)] = -0.0
    else:
        x = rng.uniform(0, 1, shape).astype(np.float32)
        if kind == "saturated":
            x[:, :h // 2, :w // 2] = 1.0
            x[:, h // 2:, w // 2:] = 0.0
    p = np.asarray([[_size01(radius)], [_size01(1 + radius % 7)]],
                   np.float32)[:shape[0]]
    g = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(p), torch.from_numpy(g)


@pytest.mark.parametrize("kind",
                         ["noise", "saturated", "quantized", "signed_zero"])
@pytest.mark.parametrize("frame", [(9, 10), (20, 17)], ids=["9x10", "20x17"])
@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("radius", range(1, 8))
def test_median_backward_algorithm_matches_autograd(radius, c, frame, kind):
    """Radii 1-7; frames from 9 x 10 (just above MAX_R: every window
    reflects at both edges, and a value is a tap of one window at up to
    nine preimages an offset) to 20 x 17; ties in runs, at the clip's exact
    0 and 1 (its 1/2), and between +0 and -0."""
    x, p, g = _case((2, *frame, c), radius, seed=70 + radius, kind=kind)
    _assert_close_to_plain(_emulate_backward(x, p, g), _plain_grads(x, p, g))
    if kind == "signed_zero":
        assert bool((torch.signbit(x) & (x == 0)).any())
        assert bool((~torch.signbit(x) & (x == 0)).any())


@pytest.mark.parametrize("radius", [1, 3, 5])
def test_a_single_share_is_the_plain_gradient_bit_for_bit(radius):
    """On noise most windows' median is one value, c = 1, and many values
    are the median of one window alone: each such value's gradient is that
    window's g k, in the emulation as in the plain form's autograd."""
    x, p, g = _case((2, 20, 17, 3), radius, seed=60 + radius, kind="noise")
    got = _emulate_backward(x, p, g)
    (wx, _), single = _plain_grads(x, p, g), got[2] == 1
    assert int(single.sum()) >= 20
    assert torch.equal(got[0][single], wx[single])
    assert bool((wx[single] != 0).all())


@pytest.mark.parametrize("value", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("radius", range(1, 8))
def test_constant_frame_splits_among_every_tap(radius, value):
    """A constant frame ties every tap of every window, c = K, and at 0 and
    1 the clip passes half the cotangent; a value's gradient is the sum of
    its K-way shares over every window that holds it."""
    x = torch.full((1, 11, 9, 3), value)
    g = torch.from_numpy(np.random.default_rng(80 + radius).standard_normal(
        x.shape).astype(np.float32))
    p = torch.tensor([[_size01(radius)]])
    got = _emulate_backward(x, p, g)
    assert bool((got[4] == (2 * radius + 1) ** 2).all())
    _assert_close_to_plain(got, _plain_grads(x, p, g))


def test_frame_above_the_direct_rows():
    """A frame above _vjp.DIRECT_ROWS, which the CPU's backward takes by
    strips of STRIP rows and the plain form by tap stacks of 64 rows: the
    kernel takes it on the same path as any other."""
    x, p, g = _case((1, 644, 9, 1), 7, seed=97, kind="quantized")
    assert x.shape[1] > _vjp.DIRECT_ROWS
    want = _vjp.vjp(km.median_plain, km.HALO, x, p, g, (True, False))
    _assert_close_to_plain(_emulate_backward(x, p, g), want)

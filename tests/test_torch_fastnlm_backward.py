"""The algorithm of csrc/fastnlm.cu's backward kernel, emulated on the CPU
in its order of sums, against torch.autograd.grad of fastnlm_plain.

The kernel recomputes num and den in the plain form's order and arithmetic
(so y and the clip's mask at an exact bound are the plain form's), forms
per pixel a = g m / (255 den), per offset the weight's and the box mean's
gradients, the reflected box's adjoint (a position outside the frame adds
onto its reflection) and T = a w + 2 (tap - x~) gD, gathers T at each
target's reflection preimages, adds U = -2 (tap - x~) gD at the pixel, and
sums params[:, 2]'s gradient in float64.  Within a launch group the
offsets pass splits each image's offsets into contiguous parts (U summed
per part), and the gather into four quarters, combined as ((q0 + q2) + (q1
+ q3)).  The emulation does the same per image, with torch on the CPU
(whose box divides where the card multiplies by the reciprocal, as the
plain form does on each device).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from reconfigisp_tpu_torch.ops.kernels import fastnlm as kf

from torch_one_thread import one_thread  # noqa: F401  (autouse)

MAX_R = kf.MAX_R
INV255 = torch.tensor(1.0 / 255.0, dtype=torch.float32)


def _size01(radius):
    return (radius - 0.5) / 7.0


def _adjoint_box(gs, b, dim):
    """The adjoint of csrc/fastnlm.cu's reflected box pass along `dim` (3:
    columns, 2: rows) as the kernel sums it at each target: its 2b+1
    sources (zero outside the frame) from the first, then the sources
    whose window reached past the near edge, then past the far edge."""
    n = gs.shape[dim]
    pad = [0, 0, 0, 0]
    pad[0 if dim == 3 else 2] = pad[1 if dim == 3 else 3] = b
    z = F.pad(gs, pad)
    out = z.narrow(dim, 0, n)
    for j in range(1, 2 * b + 1):
        out = out + z.narrow(dim, j, n)
    for t in range(n):
        lo = range(0, b - t + 1) if 1 <= t <= b else ()
        hi = range(2 * n - 2 - t - b, n) if n - 1 - b <= t <= n - 2 else ()
        for src in [*lo, *hi]:
            col = out.narrow(dim, t, 1) + gs.narrow(dim, src, 1)
            out = torch.cat([out.narrow(dim, 0, t), col,
                             out.narrow(dim, t + 1, n - t - 1)], dim)
    return out


def _part_range(count, first, group, part, parts):
    """The kernel's part_range: contiguous chunk `part` of `parts` of the
    image's own offsets in the group [first, first + group)."""
    n = max(0, min(first + group, count) - first)
    chunk = -(-n // parts)
    return range(first + min(part * chunk, n),
                 first + min(part * chunk + chunk, n))


def _parts(shape):
    """The offsets pass's parts of a group: enough that its grid of 16 x 16
    tiles of each channel plane reaches 512 blocks, at most 8."""
    n, h, w, c = shape
    return max(1, min(8, 512 // (-(-h // 16) * -(-w // 16) * c * n)))


def _preimages(q, o, n):
    """(index, valid) of the three candidates p with R(p + o) = q along one
    axis, in the kernel's order: q - o, then the reflections -q - o (q >= 1)
    and 2 (n - 1) - q - o (q <= n - 2)."""
    cands = [(q - o, torch.ones_like(q, dtype=torch.bool)),
             (-q - o, q >= 1), (2 * n - 2 - q - o, q <= n - 2)]
    return [(idx.clamp(0, n - 1), ok & (idx >= 0) & (idx < n))
            for idx, ok in cands]


def _emulate_backward(x, params, g, group=kf.OFFSETS):
    """(gx, gp) of sum(fastnlm(x, params) * g) as the kernel forms them,
    and params[:, 2]'s gradient with each term of its sum taken by its
    magnitude (the scale of that sum's rounding)."""
    n, h, w, c = x.shape
    parts = _parts(x.shape)
    b = int(kf.size01_to_radius(params[0, 0]))
    rk = torch.tensor(1.0, dtype=torch.float32) / (2 * b + 1)
    gx = torch.empty(n, c, h, w)
    gp = torch.zeros(n, 3)
    gp_scale = torch.zeros(n, dtype=torch.float64)
    rows, cols = torch.arange(h)[:, None], torch.arange(w)[None, :]
    for i in range(n):
        s = int(kf.size01_to_radius(params[i, 1]))
        hd = 1.0 + 99.0 * params[i, 2]
        inv_h2 = 1.0 / (hd ** 2)
        neg_c = -((inv_h2 * rk) * rk)
        x255 = (x[i:i + 1] * 255.0).permute(0, 3, 1, 2)
        padded = kf.reflect(kf.reflect(x255, MAX_R, 2), MAX_R, 3)
        offsets = [(ox, oy) for ox in range(-s, s + 1)
                   for oy in range(-s, s + 1)]

        def tap_mean(k):
            ox, oy = offsets[k]
            tap = padded[:, :, MAX_R + oy:MAX_R + oy + h,
                         MAX_R + ox:MAX_R + ox + w]
            return tap, kf.box_filter((tap - x255) ** 2, b)

        # stats: num and den in the plain form's order
        num = torch.zeros_like(x255)
        den = torch.zeros_like(x255)
        for k in range(len(offsets)):
            tap, mean = tap_mean(k)
            wgt = torch.exp(-mean * inv_h2)
            num = num + wgt * tap
            den = den + wgt
        y = num / den
        out = y / 255.0
        m = torch.where((out > 0) & (out < 1), 1.0,
                        torch.where((out == 0) | (out == 1), 0.5, 0.0))
        a = ((g[i:i + 1].permute(0, 3, 1, 2) * m) * INV255) / den

        e = e_abs = torch.zeros((), dtype=torch.float64)
        for first in range(0, kf.OFFSETS, group):
            ts, us = {}, []
            for part in range(parts):    # the offsets pass
                u = torch.zeros_like(x255)
                for k in _part_range(len(offsets), first, group, part, parts):
                    tap, mean = tap_mean(k)
                    wgt = torch.exp(-mean * inv_h2)
                    wd = wgt * (a * (tap - y))
                    term = wd.double() * mean.double()
                    e, e_abs = e + term.sum(), e_abs + term.abs().sum()
                    gd = _adjoint_box(_adjoint_box(neg_c * wd, b, 3), b, 2)
                    q = (2.0 * (tap - x255)) * gd
                    ts[k] = (a * wgt) + q
                    u = u - q
                us.append(u)
            quarters = []
            for quarter in range(4):    # the gather
                part_sum = torch.zeros_like(x255)
                for k in _part_range(len(offsets), first, group, quarter, 4):
                    ox, oy = offsets[k]
                    for ri, rv in _preimages(rows, oy, h):
                        for ci, cv in _preimages(cols, ox, w):
                            part_sum = part_sum + torch.where(
                                rv & cv, ts[k][:, :, ri, ci], 0.0)
                quarters.append(part_sum)
            total = (quarters[0] + quarters[2]) + (quarters[1] + quarters[3])
            acc = total if first == 0 else acc + total
            for u in us:
                acc = acc + u
        gx[i] = (acc * 255.0)[0]
        gp[i, 2] = float(e * 2.0 * 99.0 / float(hd) ** 3)
        gp_scale[i] = e_abs * 2.0 * 99.0 / float(hd) ** 3
    return gx.permute(0, 2, 3, 1), gp, gp_scale


def _plain_grads(x, params, g):
    xs, ps = x.clone().requires_grad_(), params.clone().requires_grad_()
    return torch.autograd.grad(kf.fastnlm_plain(xs, ps), (xs, ps), g)


def _case(shape, block, seed, saturated=False):
    """Images with search radii 1, 4 and 7 and decays 6.9, 50.5 and 90.1;
    with `saturated`, a patch of exact 1 and one of exact 0 in each."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, shape).astype(np.float32)
    if saturated:
        h, w = shape[1:3]
        x[:, :h // 2, :w // 2] = 1.0
        x[:, h // 2:, w // 2:] = 0.0
    p = np.asarray([[_size01(block), _size01(1), 0.06],
                    [0.0, _size01(4), 0.5], [0.0, _size01(7), 0.9]],
                   np.float32)[:shape[0]]
    g = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(p), torch.from_numpy(g)


def _assert_close_to_plain(got, want):
    """gx within 1e-5 of its largest reference value (sums in another
    order: ~4e-7 seen); params[:, 2]'s within 1e-5 of the largest sum of
    its terms' magnitudes: that sum over pixels and offsets cancels, by up
    to ~10^3 on the smallest frames, so two float32 evaluations of it can
    differ by 1e-4 of its value (the plain form's against float64: 1.5e-4)
    but not by more than rounding of its terms.  The radii's gradients are
    exact zeros in both."""
    (gx, gp, gp_scale), (wx, wp) = got, want
    assert float((gx - wx).abs().max()) <= 1e-5 * float(wx.abs().max())
    assert float((gp - wp).abs().max()) <= 1e-5 * float(gp_scale.max())
    assert torch.equal(gp[:, :2], torch.zeros_like(gp[:, :2]))
    assert torch.equal(wp[:, :2], torch.zeros_like(wp[:, :2]))


@pytest.mark.parametrize("kind", ["noise", "saturated"])
@pytest.mark.parametrize("frame", [(8, 9), (20, 17), (48, 40)],
                         ids=["8x9", "20x17", "48x40"])
@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("block", range(1, 8))
def test_fastnlm_backward_algorithm_matches_autograd(block, c, frame, kind):
    """Block radii 1-7, per-image search radii 1, 4 and 7, frames from 8 x 9
    (every box and search window reflected at both edges) to 48 x 40; the
    saturated patches put the clip's 1/2 tie where y is exactly 0 or 255."""
    x, p, g = _case((3, *frame, c), block, seed=70 + block,
                    saturated=kind == "saturated")
    _assert_close_to_plain(_emulate_backward(x, p, g), _plain_grads(x, p, g))


@pytest.mark.parametrize("group", [1, 7, 40])
def test_fastnlm_backward_groups_give_the_same_gradient(group):
    """Offsets in launch groups, as the kernel takes them at large frames:
    the earlier groups' sums carried into each gather and partial."""
    x, p, g = _case((3, 20, 17, 3), 3, seed=80)
    _assert_close_to_plain(_emulate_backward(x, p, g, group),
                           _plain_grads(x, p, g))


def test_saturated_patch_takes_the_clip_tie():
    """Where y is exactly 0 or 255 the clip passes half the cotangent, in
    the emulation's mask as in the plain form's autograd."""
    x, p, g = _case((3, 24, 24, 1), 1, seed=81, saturated=True)
    xs = x.clone().requires_grad_()
    out = kf.fastnlm_plain(xs, p)
    assert bool(((out == 0) | (out == 1)).any())
    _assert_close_to_plain(_emulate_backward(x, p, g), _plain_grads(x, p, g))


def test_backward_group_bounds_the_per_offset_fields():
    """All 225 offsets in one group at the search step's 4 x 48^2 x 3; at
    larger frames as many as keep a field within SCRATCH_VALUES."""
    assert kf.backward_group(torch.empty(4, 48, 48, 3)) == kf.OFFSETS
    for shape in [(4, 192, 192, 3), (7, 520, 776, 3), (1, 2848, 4256, 3)]:
        x = torch.empty(1).expand(*shape)
        group = kf.backward_group(x)
        assert 1 <= group < kf.OFFSETS
        assert group * x.numel() <= max(kf.SCRATCH_VALUES, x.numel())

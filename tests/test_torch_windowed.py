"""The median and fast-NLM plain PyTorch forms against the JAX forms: the jnp
reference forms, the op-level dispatch and the Pallas kernels in interpret
mode; the CPU routing of their kernel wrappers; and the arithmetic of the
bilateral, median and fast-NLM CUDA kernels emulated on the CPU."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reconfigisp_tpu.ops import denoise as jdenoise
from reconfigisp_tpu.ops.pallas_kernels import fastnlm_pallas, median_pallas

from chip_smoke import BILATERAL_ROWS, MEDIAN_NETWORK_MINMAX
from reconfigisp_tpu_torch import registry
from reconfigisp_tpu_torch.ops import denoise
from reconfigisp_tpu_torch.ops.kernels import bilateral as kb
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


# csrc/median.cu's selection, emulated on the CPU: radii up to
# _NETWORK_MAX_R take the networks over a 2x2 block of pixels, larger ones
# the bisection of each pixel
_NETWORK_MAX_R = 4


def _batcher_pairs(n):
    """Batcher's odd-even merge sort over n slots in csrc/median.cu's
    merge_step order: steps (p, d) = (1, 1), (2, 2), (2, 1), (4, 4), ...;
    each pair (a, b) puts the min in a and the max in b."""
    pairs = []
    p = 1
    while p < n:
        d = p
        while d >= 1:
            for j in range(d % p, n - d, 2 * d):
                for i in range(d):
                    a, b = i + j, i + j + d
                    if b < n and a // (2 * p) == b // (2 * p):
                        pairs.append((a, b))
            d //= 2
        p *= 2
    return pairs


def _pruned_network(k, reads):
    """(n, live): the network over n = 2^ceil(log2 k) slots whose last n - k
    hold the largest key, as the compiler leaves it when only the slots
    `reads` are read.  A comparator whose b holds the pad is a no-op and
    goes; none has the pad in a alone.  Then, back from the slots read, a
    comparator none of whose outputs is read later goes, and the rest are
    (a, b, min_read, max_read)."""
    n = 1 << (k - 1).bit_length()
    pad = [i >= k for i in range(n)]
    folded = []
    for a, b in _batcher_pairs(n):
        assert not (pad[a] and not pad[b])
        if not pad[b]:
            folded.append((a, b))
    read = [i in reads for i in range(n)]
    live = []
    for a, b in reversed(folded):
        lo, hi = read[a], read[b]
        if lo or hi:
            read[a] = read[b] = True
            live.append((a, b, lo, hi))
    return n, live[::-1]


def _network_plan(radius):
    """The kernel's constants for a 2x2 block: the common taps (rows and
    columns -r+1..r) and each pixel's own u = 2S - 1; the median, index k of
    the window, is rank kp of the common taps' sorted ranks lo..hi merged
    with the sorted own taps; the merge's terms i, and the slots each
    network must deliver."""
    s = 2 * radius + 1
    k, m, u = s * s // 2, 2 * radius, 2 * s - 1
    lo, hi = max(0, k - u), min(k, m * m - 1)
    kp = k - lo + 1
    terms = range(max(0, kp - u), min(kp, hi - lo + 1) + 1)
    common_reads = {lo + i - 1 for i in terms if i > 0}
    own_reads = {kp - i - 1 for i in terms if i < kp}
    return m, u, lo, kp, terms, common_reads, own_reads


def _network_counts(radius):
    """min/max of one 2x2 block and channel: the common network, then per
    pixel the own network, a max per term with both lists, and a min
    between successive terms."""
    m, u, _, kp, terms, common_reads, own_reads = _network_plan(radius)
    minmax = lambda live: sum(lo + hi for _, _, lo, hi in live)
    merge = sum(0 < i < kp for i in terms) + len(terms) - 1
    return (minmax(_pruned_network(m * m, common_reads)[1])
            + 4 * (minmax(_pruned_network(u, own_reads)[1]) + merge))


def _float_keys(v):
    """The kernel's order-preserving key of each float32, as int64."""
    u = v.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(u >= 1 << 31, 0xFFFFFFFF ^ u, u | 1 << 31)


def _key_floats(k):
    u = torch.where(k >= 1 << 31, k & 0x7FFFFFFF, 0xFFFFFFFF ^ k)
    return torch.where(u >= 1 << 31, u - (1 << 32), u).to(
        torch.int32).view(torch.float32)


def _network_apply(taps, reads):
    """The pruned network on stacked keys; returns its slots.  A slot that
    held the pad, or whose value was not to be kept, holds None, so that
    reading it raises."""
    n, live = _pruned_network(len(taps), reads)
    t = list(taps) + [None] * (n - len(taps))
    for a, b, lo, hi in live:
        t[a], t[b] = (torch.minimum(t[a], t[b]) if lo else None,
                      torch.maximum(t[a], t[b]) if hi else None)
    return t


def _bisect_select(taps):
    """The kernel's 32-pass bisection: the least key with at least
    k // 2 + 1 taps at or below it."""
    rank = len(taps) // 2 + 1
    lo = torch.zeros_like(taps[0])
    hi = torch.full_like(taps[0], 0xFFFFFFFF)
    for _ in range(32):
        mid = lo + (hi - lo) // 2
        count = sum((t <= mid).to(torch.int64) for t in taps)
        hi = torch.where(count >= rank, mid, hi)
        lo = torch.where(count >= rank, lo, mid + 1)
    return lo


def _median_kernel_selection(x, params):
    """csrc/median.cu in plain PyTorch on a frame of even H and W: the keys
    of the reflect-padded frame; per 2x2 block of pixels (top-left at even
    coordinates) the common taps' network, then per pixel its own row and
    column, their network and the merge of the two sorted lists; or, above
    _NETWORK_MAX_R, the bisection of each pixel's window."""
    _, h, w, _ = x.shape
    r = int(km.size01_to_radius(params[0, 0]))
    keys = _float_keys(km.pad_reflect(x, r))
    if r > _NETWORK_MAX_R:
        return torch.clamp(_key_floats(_bisect_select(
            [keys[:, r + dy:r + dy + h, r + dx:r + dx + w]
             for dy in range(-r, r + 1) for dx in range(-r, r + 1)])), 0.0, 1.0)
    # the tap at (dy, dx) from every block's top-left pixel
    tap = lambda dy, dx: keys[:, r + dy:r + dy + h:2, r + dx:r + dx + w:2]
    m, u, lo, kp, terms, common_reads, own_reads = _network_plan(r)
    s = 2 * r + 1
    a = _network_apply([tap(i // m - r + 1, i % m - r + 1) for i in range(m * m)],
                       common_reads)
    out = torch.empty_like(keys[:, :h, :w])
    for y in range(2):
        for x_ in range(2):
            ey, ex = (r + 1 if y else -r), (r + 1 if x_ else -r)
            own = _network_apply(
                [tap(ey, x_ - r + i) for i in range(s)]
                + [tap(i - r + 1, ex) for i in range(s - 1)], own_reads)
            med = None
            for i in terms:
                t = (own[kp - 1] if i == 0 else a[lo + i - 1] if i == kp
                     else torch.maximum(a[lo + i - 1], own[kp - i - 1]))
                med = t if med is None else torch.minimum(med, t)
            out[:, y::2, x_::2] = med
    return torch.clamp(_key_floats(out), 0.0, 1.0)


def _median_test_image(kind, c):
    rng = np.random.default_rng(51)
    shape = (2, 20, 28, c)
    u = rng.uniform(0, 1, shape)
    if kind == "noise":
        x = u
    elif kind == "edge":
        x = np.where(np.arange(shape[2]) < 13, 0.02, 0.98)[:, None] + 0.01 * u
    elif kind == "saturated":   # runs of exact 0.0 and 1.0, as after Malvar
        x = np.clip(2 * u - 0.5, 0, 1)
    elif kind == "constant":
        x = np.full(shape, 0.37)
    elif kind == "out_of_range":
        x = 3 * u - 1
    else:                       # signed zeros among tiny values of both signs
        x = rng.choice([-0.0, 0.0, -1e-38, 1e-38, -1e-45, 0.5], shape)
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize("radius", range(1, _NETWORK_MAX_R + 1))
def test_median_network_counts(radius):
    """The min/max per 2x2 block and channel that survive the folding and
    pruning, as csrc/median.cu's note states them and chip_smoke.py's phase
    2 holds the SASS to them."""
    assert _network_counts(radius) == MEDIAN_NETWORK_MINMAX[radius]


@pytest.mark.parametrize("kind", ["noise", "edge", "saturated", "constant",
                                  "out_of_range", "signed_zero"])
@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("radius", range(1, 8))
def test_median_kernel_selection_equals_plain(radius, c, kind):
    """The kernel's selection (networks for r <= 4, bisection above) on the
    CPU against the plain form: bit-identical, before any card."""
    x = _median_test_image(kind, c)
    p = torch.tensor([[_size01(radius)], [0.99]])
    assert torch.equal(_median_kernel_selection(x, p), km.median_plain(x, p))


@pytest.mark.parametrize("radius", range(1, _NETWORK_MAX_R + 1))
def test_median_networks_zero_one_principle(radius):
    """A comparator network selects ranks correctly on every input if and
    only if it does so on every 0-1 input.  Random 0-1 windows with every
    count of ones from 0 to K, laid out as the kernel reads a 2x2 block's
    common taps and each pixel's own ones, give 1 exactly where the ones
    are a majority of that pixel's window."""
    s = 2 * radius + 1
    k = s * s
    trials = 32
    rng = np.random.default_rng(52)
    ones = np.arange(k)[:, None, None] < np.arange(k + 1)[None, :, None]
    windows = rng.permuted(np.broadcast_to(ones, (k, k + 1, trials)), axis=0)
    # each window is pixel (r, r)'s in a frame of (S+1)^2 zeros, one of the
    # four pixels of a 2x2 block
    frame = np.zeros((k + 1, trials, s + 1, s + 1), np.float32)
    frame[:, :, :s, :s] = windows.reshape(s, s, k + 1, trials).transpose(2, 3, 0, 1)
    x = torch.from_numpy(frame.reshape(-1, s + 1, s + 1, 1))
    p = torch.full((x.shape[0], 1), _size01(radius))
    got = _median_kernel_selection(x, p)[:, radius, radius, 0]
    want = np.broadcast_to(np.arange(k + 1)[:, None] >= k // 2 + 1,
                           (k + 1, trials)).reshape(-1)
    assert torch.equal(got, torch.from_numpy(want.astype(np.float32)))


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
    """chip_smoke.py's count of MUFU.EX2 per body follows the rows a thread
    owns in csrc/bilateral.cu."""
    src = (Path(kb.__file__).resolve().parents[2] / "csrc" / "bilateral.cu"
           ).read_text()
    assert re.search(r"constexpr int kRows = (\d+);", src)[1] == str(
        BILATERAL_ROWS)


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

"""The median's plain PyTorch form against the JAX forms (the jnp
reference form, the op-level dispatch and the Pallas kernel in interpret
mode), the arithmetic of csrc/median.cu's selection emulated on the CPU, the
capture-safe route of the plain form against its host-read route, and the
CPU routing of the median and fast-NLM kernel wrappers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reconfigisp_tpu.ops import denoise as jdenoise
from reconfigisp_tpu.ops.pallas_kernels import median_pallas

from reconfigisp_tpu_torch import registry
from reconfigisp_tpu_torch.ops import denoise
from reconfigisp_tpu_torch.ops.kernels import fastnlm as kf
from reconfigisp_tpu_torch.ops.kernels import median as km

from test_torch_windowed_bilateral import assert_routes_agree
from torch_one_thread import one_thread  # noqa: F401  (autouse)

# jitted so that one compile per shape serves every radius
_MEDIAN_REFS = {"jnp": jax.jit(jdenoise._median_jnp),
                "op_dispatch": jax.jit(jdenoise.median)}


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
    pruning, as csrc/median.cu's note states them and
    tests/test_torch_cuda_build.py holds the SASS to them."""
    assert _network_counts(radius) == km.MEDIAN_NETWORK_MINMAX[radius]


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



# ------------------------------------------------- capture-safe route

@pytest.mark.parametrize("kind", ["noise", "saturated"])
@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("radius", range(1, 8))
def test_median_capture_safe_route_equals_host_route(radius, c, kind):
    """All seven radii selected on the device against the radius read on
    the host; saturated input (runs of exact 0 and 1) makes ties, whose
    cotangent the tie split shares out.  70 rows: a strip and a part."""
    u = _image((2, 70, 24, c), seed=59)
    x = torch.from_numpy(np.clip(2 * u - 0.5, 0, 1) if kind == "saturated"
                         else u)
    p = torch.tensor([[_size01(radius)], [0.99]])
    assert_routes_agree(km.median_plain, x, p)


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


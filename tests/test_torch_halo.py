"""The space axis's windows and halo radii (reconfigisp_tpu_torch/parallel/
space.py), with no process group.

  * the window rule: every rank's window holds its owned rows with the
    halo on each side or the frame's edge, starts on an even row, and has
    the one height of every rank; the owned rows split the frame as JAX's
    NamedSharding does;
  * for every op of the three pools, native and proxy, the owned rows of
    the op run on each of three ranks' windows, at the radius space.RADIUS
    gives, equal the whole-frame op's rows to 1e-6: the windowed ops at
    their largest radii, the learned nets with their init weights.  The
    global ops run under a one-rank context, where the reductions are the
    identity (the frame is the window), against the op without one; the
    SRCNN proxies' conditioning is the frame's, so their windows hold the
    conv stack's radius.  dct_denoise, bm3d's tuning target, at windows on
    multiples of 8;
  * the space custom ops without a group: their values, gradients and fake
    shapes, and a pipeline's intermediates trimmed under a context.
"""

import numpy as np
import pytest
import torch

import reconfigisp_tpu_torch as rt
from reconfigisp_tpu_torch.ops import cnn, denoise
from reconfigisp_tpu_torch.parallel import space
from reconfigisp_tpu_torch.supernet import SuperNet
from torch_one_thread import one_thread  # noqa: F401  (autouse)

WIDTH = 16
RANKS = 3
TOL = 1e-6
GLOBAL = {"grayworld", "whiteworld", "reinhard", "conditional_gamma",
          "conditional_wb_manual", "conditional_wb_quadratic"}


@pytest.mark.parametrize("height", [2, 6, 24, 96, 2848])
@pytest.mark.parametrize("size", [1, 2, 3, 4])
@pytest.mark.parametrize("halo", [0, 1, 7, 28, 51, 200])
def test_window_rule(height, size, halo):
    if height % size:
        with pytest.raises(ValueError, match="does not split"):
            space.window(height, 0, size, halo)
        return
    wins = [space.window(height, s, size, halo) for s in range(size)]
    assert len({w.rows for w in wins}) == 1
    assert wins[0].rows == space.window_rows(height, size, halo)
    part = height // size
    for s, w in enumerate(wins):
        assert (w.own_start, w.own_stop) == (s * part, (s + 1) * part)
        assert 0 <= w.start and w.stop <= height and w.start % 2 == 0
        assert w.rows % 2 == 0 or w.rows == height
        assert w.start == 0 or w.own_start - w.start >= halo
        assert w.stop == height or w.stop - w.own_stop >= halo
        assert w.trim == slice(w.own_start - w.start, w.own_stop - w.start)
    if halo >= height - part:   # the first rank's reach is the frame
        assert all((w.start, w.stop) == (0, height) for w in wins)


def test_radius_of_nets():
    assert space.radius(rt.Pipeline(
        "Bayer_01_Demosaic_03_sRGB_08_09_01_13_11", device="cpu")) == 51
    assert space.radius(rt.Pipeline(
        "Bayer_02_Demosaic_02_sRGB_02", True, device="cpu")) == 12 + 8
    assert space.radius(SuperNet(1, 0.2, srgb_count=7, device="cpu")) == \
        28 + 12 + 7
    assert space.radius(SuperNet(2, 0.2, use_proxies=True,
                                 device="cpu")) == 28 + 12 + 2 * 14


def _cases():
    for domain in ("bayer", "demosaic", "srgb"):
        for spec in rt.pool(domain):
            forms = []
            if spec.apply is not None:
                forms.append(False)
            if spec.proxy_apply is not None:
                forms.append(True)
            for use_proxy in forms:
                yield pytest.param(domain, spec.name, use_proxy,
                                   id=f"{domain}-{spec.name}-"
                                      f"{'proxy' if use_proxy else 'native'}")


def _op(domain, name, use_proxy, n, gen):
    spec = rt.get_op(domain, name)
    init = spec.get_init(use_proxy)
    weights = init(gen) if init is not None else None
    if spec.conditional:
        params = spec.init_params(gen)
    elif spec.n_params:
        params = torch.ones((n, spec.n_params))   # the largest radii
    else:
        params = None
    return spec.get_apply(use_proxy), params, weights


def _input(domain, n, height, seed):
    c = 3 if domain == "srgb" else 1
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        0.02, 0.98, (n, height, WIDTH, c)).astype(np.float32))


@pytest.mark.parametrize("domain,name,use_proxy", list(_cases()))
def test_op_on_windows_matches_the_frame(domain, name, use_proxy):
    spec = rt.get_op(domain, name)
    halo = space.op_radius(spec, use_proxy)
    assert halo is not None
    gen = torch.Generator().manual_seed(5)
    fn, params, weights = _op(domain, name, use_proxy, 2, gen)
    # the shortest frame, a multiple of 6, whose middle rank's window of
    # height / 3 + 2 halo rows (and 2 of rounding) is shorter than it
    height = 6 * ((3 * halo + 4) // 6 + 1)
    x = _input(domain, 2, height, seed=len(name))
    with torch.no_grad():
        whole = fn(x, params, weights)
        if name in GLOBAL and not use_proxy:
            with space.whole_frame(height):
                got = fn(x, params, weights)
            np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=0,
                                       atol=TOL)
            assert halo == 0
            return
        if use_proxy and domain == "srgb":
            stats = cnn._frame_stats(x)
            cnn_stats = cnn._frame_stats
            cnn._frame_stats = lambda _: stats
        try:
            for s in range(RANKS):
                win = space.window(height, s, RANKS, halo)
                assert win.rows < height   # a real window
                y = fn(x[:, win.start:win.stop], params, weights)
                np.testing.assert_allclose(
                    y[:, win.trim].numpy(),
                    whole[:, win.own_start:win.own_stop].numpy(), rtol=0,
                    atol=TOL, err_msg=f"rank {s} of {win}")
        finally:
            if use_proxy and domain == "srgb":
                cnn._frame_stats = cnn_stats


def test_dct_denoise_on_windows_matches_the_frame():
    height = 96
    x = _input("srgb", 2, height, seed=3)
    params = torch.ones((2, 5))
    with torch.no_grad():
        whole = denoise.dct_denoise(x, params)
        for own in (0, 32, 64):
            start = max(0, own - space.DCT_DENOISE_RADIUS)
            stop = min(height, own + 32 + space.DCT_DENOISE_RADIUS)
            y = denoise.dct_denoise(x[:, start:stop], params)
            np.testing.assert_allclose(
                y[:, own - start:own - start + 32].numpy(),
                whole[:, own:own + 32].numpy(), rtol=0, atol=TOL)


def test_srcnn_stats_under_a_one_rank_context():
    x = _input("srgb", 2, 24, seed=9).requires_grad_(True)
    want = cnn._frame_stats(x)
    with space.whole_frame(24):
        got = cnn._frame_stats(x)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    ga = torch.autograd.grad(sum(t.sum() for t in got), x)[0]
    gb = torch.autograd.grad(sum(t.sum() for t in want), x)[0]
    assert torch.equal(ga, gb)


def test_space_ops_without_a_group():
    """One rank: the sum is over the window's owned rows and its gradient
    lands on them; over a whole-frame window the gather is the frame and
    passes its gradient through; without a context the sum is the plain
    one and the gather a copy."""
    x = torch.arange(2 * 8 * 3, dtype=torch.float32).reshape(2, 8, 3)
    x.requires_grad_(True)
    with space.context(None, space.Window(0, 8, 2, 6), 8):
        s = space.frame_sum(x)
    assert torch.equal(s, x.detach()[:, 2:6].sum(1))
    g = torch.autograd.grad((s * 2).sum(), x)[0]
    want = torch.zeros_like(x)
    want[:, 2:6] = 2.0
    assert torch.equal(g, want)
    with space.whole_frame(8):
        rows = space.gather(x)
    assert torch.equal(rows, x.detach())
    assert torch.equal(torch.autograd.grad((rows * 3).sum(), x)[0],
                       torch.full_like(x, 3.0))
    assert torch.equal(space.frame_sum(x.detach()), x.detach().sum(1))
    assert torch.equal(space.gather(x.detach()), x.detach())


def test_space_ops_are_opaque_to_export():
    """torch.export keeps both ops as calls in the program (no constant
    folding), with the frame's height from the context it traced under."""
    class Net(torch.nn.Module):
        def forward(self, x):
            return space.frame_sum(x) + space.gather(x).mean(1)

    with space.whole_frame(8):
        ep = torch.export.export(Net(), (torch.zeros(2, 8, 3),))
    targets = {str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"}
    assert "reconfigisp.space_sum.default" in targets
    assert "reconfigisp.space_rows.default" in targets
    x = torch.rand(2, 8, 3)
    with space.whole_frame(8):
        got = ep.module()(x)
    torch.testing.assert_close(got, x.sum(1) + x.mean(1), rtol=0, atol=1e-6)


def test_pipeline_trims_its_intermediates_under_a_context():
    pipe = rt.Pipeline("Bayer_02_Demosaic_02_sRGB_05_02", device="cpu")
    x = _input("bayer", 1, 12, seed=1)
    win = space.Window(0, 12, 0, 12)
    with torch.no_grad(), space.context(None, space.Window(0, 12, 4, 8), 12):
        y, mids, _ = pipe(x, return_intermediates=True)
    assert y.shape[1] == 12
    assert all(m.shape[1] == 4 for m in mids.values())
    with torch.no_grad(), space.context(None, win, 12):
        y2 = pipe(x)
    with torch.no_grad():
        y3 = pipe(x)
    torch.testing.assert_close(y2, y3, rtol=0, atol=TOL)

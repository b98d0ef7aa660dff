"""The bilateral, median and fast-NLM CUDA kernels against their plain
PyTorch forms, on the card, forward and backward, a few steps of step-2
training through them, and the supernet and a second-order DARTS step
through them.

Needs an NVIDIA GPU and nvcc; every test skips without a card.  The file
imports no JAX, so on a machine without JAX it runs alone:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

import reconfigisp_tpu_torch as rt
from reconfigisp_tpu_torch import convert
from reconfigisp_tpu_torch.ops import denoise
from reconfigisp_tpu_torch.ops.kernels import _vjp
from reconfigisp_tpu_torch.ops.kernels import bilateral as kb
from reconfigisp_tpu_torch.ops.kernels import fastnlm as kf
from reconfigisp_tpu_torch.ops.kernels import median as km
from reconfigisp_tpu_torch.search import IspTrainer
from reconfigisp_tpu_torch.search.darts import (
    DartsConfig, init_darts_opt_state, make_darts_step)
from reconfigisp_tpu_torch.supernet import SuperNet
from reconfigisp_tpu_torch.utils import losses

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _case(shape, p, device):
    x = np.random.default_rng(31).uniform(0, 1, shape).astype(np.float32)
    return (torch.from_numpy(x).to(device),
            torch.as_tensor(np.asarray(p, np.float32), device=device))


_RADII = [[(r - 1 + 0.5) / 7.0, 0.1 * r, 0.05 + 0.1 * r] for r in range(1, 8)]


def _bilateral_rows(sigma):
    """Radii 1..7, distinct sigmas; or both sigma01 = `sigma`: 0 gives the
    most peaked weights (sigma 1), 1 the flattest (sigma 100)."""
    if sigma is None:
        return _RADII
    return [[(r - 0.5) / 7.0, sigma, sigma] for r in range(1, 8)]


@pytest.mark.parametrize("sigma", [None, 0.0, 1.0])
@pytest.mark.parametrize("kind", ["uniform", "saturated", "constant"])
@pytest.mark.parametrize("shape", [
    (7, 64, 96, 3), (7, 40, 72, 1),
    (7, 520, 776, 3),                            # no block size divides it
])
def test_kernel_matches_plain(cuda, shape, kind, sigma):
    """Radii 1..7, one per image, within 2e-5 of the plain form: one exp2
    per tap against two expf.  Saturated input, clamped from 2 u - 0.5, has
    runs of exact 0.0 and 1.0; a constant frame gives every tap weight
    exp2 of its spatial term alone."""
    x, p = _case(shape, _bilateral_rows(sigma), cuda)
    if kind == "saturated":
        x = torch.clamp(2.0 * x - 0.5, 0.0, 1.0)
    elif kind == "constant":
        x = torch.full_like(x, 0.37)
    before = kb.launches
    got = kb.bilateral(x, p)
    torch.cuda.synchronize()
    assert kb.launches == before + 1
    want = kb.bilateral_plain(x, p)
    assert float((got - want).abs().max()) <= 2e-5


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x, p = _case((1, 16, 16, 3), [[0.5, 0.5, 0.5]], cuda)
    with pytest.raises(TypeError):
        kb.bilateral(x.double(), p)
    with pytest.raises(ValueError):
        kb.bilateral(x[:, :6], p)
    with pytest.raises(ValueError):
        kb.bilateral(torch.cat([x, x[..., :1]], -1), p)


def test_wrapper_copies_strided_input(cuda):
    """The kernel reads contiguous NHWC; a strided view and expanded params
    (as Pipeline passes them) are copied first, not refused."""
    x, p = _case((2, 16, 24, 3), [[0.5, 0.2, 0.3]], cuda)
    xt, pe = x.transpose(1, 2), p.expand(2, 3)
    got = kb.bilateral(xt, pe)
    want = kb.bilateral(xt.contiguous(), pe.contiguous())
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# ------------------------------------------------------------------ median

@pytest.mark.parametrize("kind", ["uniform", "saturated", "constant"])
@pytest.mark.parametrize("shape", [(3, 64, 96, 3), (3, 40, 72, 1),
                                   (1, 520, 776, 3), (2, 41, 73, 1)])
@pytest.mark.parametrize("radius", range(1, 8))
def test_median_kernel_equals_plain(cuda, shape, radius, kind):
    """Both select the exact middle tap: bit-identical.  Saturated input,
    clamped from 2 u - 0.5, has runs of exact 0.0 and 1.0 (as Malvar's
    clamp leaves them); a constant frame is all ties.  At odd H and W the
    kernel's 2x2 blocks of pixels overhang the frame."""
    x, p = _case(shape, [[(radius - 0.5) / 7.0]] * shape[0], cuda)
    if kind == "saturated":
        x = torch.clamp(2.0 * x - 0.5, 0.0, 1.0)
    elif kind == "constant":
        x = torch.full_like(x, 0.37)
    before = km.launches
    got = km.median(x, p)
    torch.cuda.synchronize()
    assert km.launches == before + 1
    assert torch.equal(got, km.median_plain(x, p))


# ------------------------------------------------------------------ fast NLM

def _nlm_rows(block, n):
    """Row 0 sets the block radius; search radii 1..7 and decays vary."""
    return [[(block - 0.5) / 7.0 if i == 0 else 0.0,
             (i % 7 + 0.5) / 7.0, 0.05 + 0.13 * i] for i in range(n)]


@pytest.mark.parametrize("shape", [(7, 48, 64, 3), (7, 40, 24, 1),
                                   (1, 520, 776, 3)])
@pytest.mark.parametrize("block", range(1, 8))
def test_fastnlm_kernel_matches_plain(cuda, shape, block):
    """Sums in another order, one folded scale and exp2 against the plain
    form's expf of a quotient: 5e-5."""
    x, p = _case(shape, _nlm_rows(block, shape[0]), cuda)
    before = kf.launches
    got = kf.fastnlm(x, p)
    torch.cuda.synchronize()
    assert kf.launches == before + 1
    want = kf.fastnlm_plain(x, p)
    assert float((got - want).abs().max()) <= 5e-5


@pytest.mark.parametrize("shape,block,search", [
    ((2, 9, 200, 3), 1, (7, 4)), ((2, 9, 200, 3), 4, (7, 4)),
    ((2, 9, 200, 3), 7, (7, 4)), ((2, 200, 9, 1), 1, (7, 4)),
    ((2, 200, 9, 1), 4, (7, 4)), ((2, 200, 9, 1), 7, (7, 4)),
    ((1, 520, 776, 3), 7, (7,)),
])
def test_fastnlm_kernel_ragged_and_narrow_frames(cuda, shape, block, search):
    """Frames that no 32x32 tile divides, one side just above MAX_R: the
    ragged tiles are masked and every thread still reaches every barrier."""
    rows = [[(block - 0.5) / 7.0 if i == 0 else 0.0, (s - 0.5) / 7.0,
             0.83 - 0.33 * i] for i, s in enumerate(search)]
    x, p = _case(shape, rows, cuda)
    before = kf.launches
    got = kf.fastnlm(x, p)
    torch.cuda.synchronize()
    assert kf.launches == before + 1
    want = kf.fastnlm_plain(x, p)
    assert float((got - want).abs().max()) <= 5e-5


# ------------------------------------------------------------------ wrappers

_OPS = {"bilateral": (kb.bilateral, 3), "median": (km.median, 1),
        "fastnlm": (kf.fastnlm, 3)}


@pytest.mark.parametrize("name", ["median", "fastnlm"])
def test_wrappers_reject_what_the_kernels_do_not_take(cuda, name):
    op, n_params = _OPS[name]
    x, p = _case((1, 16, 16, 3), [[0.5] * n_params], cuda)
    with pytest.raises(TypeError):
        op(x.double(), p)
    with pytest.raises(ValueError):
        op(x[:, :6], p)
    with pytest.raises(ValueError):
        op(torch.cat([x, x[..., :1]], -1), p)
    with pytest.raises(ValueError):
        op(x, torch.cat([p, p], -1))


@pytest.mark.parametrize("name", ["median", "fastnlm"])
def test_wrappers_copy_strided_input(cuda, name):
    op, n_params = _OPS[name]
    x, p = _case((2, 16, 24, 3), [[0.5] * n_params], cuda)
    xt, pe = x.transpose(1, 2), p.expand(2, n_params)
    got = op(xt, pe)
    want = op(xt.contiguous(), pe.contiguous())
    torch.cuda.synchronize()
    assert torch.equal(got, want)


_PLAIN = {"bilateral": kb.bilateral_plain, "median": km.median_plain,
          "fastnlm": kf.fastnlm_plain}
_MODULES = {"bilateral": kb, "median": km, "fastnlm": kf}


def _grad_rows(name, n):
    """Radius 7 for image 0 (the batch's median and fast-NLM block radius),
    then radii 6, 5, ... with distinct sigmas and decays."""
    r = [(max(7 - i, 1) - 0.5) / 7.0 for i in range(n)]
    if name == "median":
        return [[v] for v in r]
    return [[v, 0.05 + 0.2 * i, 0.1 + 0.15 * i] for i, v in enumerate(r)]


@pytest.mark.parametrize("shape", [(3, 48, 40, 3), (4, 48, 48, 3),
                                   (2, 700, 24, 1)],
                         ids=["direct", "search", "strip"])
@pytest.mark.parametrize("name", ["bilateral", "median", "fastnlm"])
def test_op_gradient_on_cuda_is_the_plain_forms(cuda, name, shape):
    """An input that requires grad launches the kernel, and its gradient for
    x and params is the plain form's autograd: bit for bit where the
    backward is direct (<= 640 rows), within 1e-5 (the params' within 1e-5
    of their largest value: a sum over the frame in another order) where
    it goes by strips."""
    x, p = _case(shape, _grad_rows(name, shape[0]), cuda)
    g = torch.randn(shape, generator=torch.Generator(cuda).manual_seed(5),
                    device=cuda)
    mod = _MODULES[name]
    grads = []
    for fn in (getattr(denoise, name), _PLAIN[name]):
        xs, ps = x.clone().requires_grad_(), p.clone().requires_grad_()
        before = mod.launches
        out = fn(xs, ps)
        assert mod.launches == before + (fn is not _PLAIN[name])
        grads.append(torch.autograd.grad(out, (xs, ps), g, allow_unused=True))
    torch.cuda.synchronize()
    (gx, gp), (wx, wp) = grads
    assert (gp is None) == (wp is None) == (name == "median")
    if shape[1] <= _vjp.DIRECT_ROWS:
        assert torch.equal(gx, wx)
        assert gp is None or torch.equal(gp, wp)
        return
    assert float((gx - wx).abs().max()) <= 1e-5
    if gp is not None:
        scale = max(1.0, float(wp.abs().max()))
        assert float((gp - wp).abs().max()) <= 1e-5 * scale


def test_isp_trainer_on_cuda_follows_the_cpu(cuda):
    """Three IspTrainer steps on the median + fast-NLM path, on the card
    (one launch of each kernel a step) and on the CPU from the same state,
    TF32 off: losses within 1e-4 relative and logits within 1e-4 (the
    kernels' forward tolerances and cuDNN's order of sums, through Adam's
    scale-free step at lr 1e-3)."""
    arch = "Bayer_01_Demosaic_03_sRGB_08_09_01_13_11"
    rng = np.random.default_rng(32)
    batch = {"noisy": rng.uniform(0.02, 0.6, (2, 64, 64, 1)).astype(
        np.float32),
             "gt": rng.uniform(0.05, 0.95, (2, 64, 64, 3)).astype(np.float32)}
    opt = {"lr_G": 1e-3, "lr_steps": [2]}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        cpu = IspTrainer(rt.Pipeline(arch, device="cpu"), opt)
        card = IspTrainer(rt.Pipeline(arch, device=cuda), opt)
        card.pipeline.load_state(convert.state_from_jax(
            convert.state_to_jax(cpu.pipeline)))
        km.launches = kf.launches = 0
        got = [card.train_step(batch)["loss"] for _ in range(3)]
        assert (km.launches, kf.launches) == (3, 3)
        want = [cpu.train_step(batch)["loss"] for _ in range(3)]
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    np.testing.assert_allclose(got, want, rtol=1e-4)
    got_logits = convert.state_to_jax(card.pipeline)["logits"]
    for name, value in convert.state_to_jax(cpu.pipeline)["logits"].items():
        np.testing.assert_allclose(got_logits[name], value, atol=1e-4,
                                   err_msg=name)


def _supernets(device):
    """SID_search's native slots (15 sRGB ops) at n_step 1 on the card: one
    net with the kernels, one with their plain forms, the same variables."""
    nets = []
    for plain in (False, True):
        net = SuperNet(1, 0.2, srgb_count=15, device=device)
        if plain:
            net.slots = [(slot, [dataclasses.replace(
                s, apply=lambda x, p, w, f=_PLAIN[s.name]: f(x, p))
                if s.name in _PLAIN else s for s in ops])
                for slot, ops in net.slots]
        nets.append(net)
    return nets, nets[0].init(torch.Generator().manual_seed(0))


def _search_batch(device):
    rng = np.random.default_rng(33)
    mk = lambda c: torch.from_numpy(rng.uniform(
        0.05, 0.95, (4, 48, 48, c)).astype(np.float32)).to(device)
    return {"img": mk(1), "gt": mk(3), "val_img": mk(1), "val_gt": mk(3)}


def test_supernet_on_cuda_kernels_vs_plain(cuda):
    """The supernet's output with the kernels in its slot against the plain
    forms, TF32 off: within 1e-5 (the kernels' 2e-5 and 5e-5 in candidates
    weighted 1/15), each kernel launched once."""
    (net, plain), v = _supernets(cuda)
    x = _search_batch(cuda)["img"]
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        kb.launches = km.launches = kf.launches = 0
        with torch.no_grad():
            got, want = net(v, x), plain(v, x)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert (kb.launches, km.launches, kf.launches) == (1, 1, 1)
    assert float((got - want).abs().max()) <= 1e-5


def test_darts_step_on_cuda_kernels_vs_plain(cuda):
    """One second-order step with the kernels (their inputs and params take
    gradients) against the plain forms, TF32 off: losses within 1e-5
    relative, alphas within 1e-5, theta within 1e-6 (chip_smoke.py's
    SEARCH_*_TOL and their reasons)."""
    nets, v = _supernets(cuda)
    batch = _search_batch(cuda)
    results = []
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for net in nets:
            def fwd(theta, alphas, omega, img, net=net):
                y, aux = net({"theta": theta, "alphas": alphas,
                              "omega": omega}, img, return_aux=True)
                return y, aux["latency"]
            step = make_darts_step(fwd, losses.make_criterion("l2"),
                                   DartsConfig())
            kb.launches = km.launches = kf.launches = 0
            results.append(step(v, init_darts_opt_state(v), batch, 1.0))
            results[-1] += ((kb.launches, km.launches, kf.launches),)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    (kv, _, klogs, kcount), (pv, _, plogs, pcount) = results
    assert min(kcount) >= 5 and pcount == (0, 0, 0)
    for k in ("loss", "val_loss"):
        assert abs(float(klogs[k]) - float(plogs[k])) <= 1e-5 * abs(
            float(plogs[k]))
    for slot in kv["alphas"]:
        assert float((kv["alphas"][slot] - pv["alphas"][slot]).abs().max()
                     ) <= 1e-5
        for op in kv["theta"][slot]:
            assert float((kv["theta"][slot][op] - pv["theta"][slot][op])
                         .abs().max()) <= 1e-6

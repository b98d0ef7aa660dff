"""The bilateral, median and fast-NLM CUDA kernels against their plain
PyTorch forms, on the card, forward and backward, a few steps of step-2
training through them, the supernet and a second-order DARTS step through them,
the train and test CLIs on the card, the YOLOv3 evaluator's forward and
criterion gradient on the card against the CPU, every op of the zoo on the
card against the CPU, the latency table timed on the card, and the kernels
as custom ops: opcheck, their gradients, the three backward kernels
repeated and replayed bit for bit, and serving artifacts
exported on the card and on the CPU; the search step captured as a CUDA
graph against the eager step (second and first order, the proxy-tuning
trainer around a tuning round, the detection objective, and one NCCL rank
with the all-reduces inside the graph), K-step dispatch, launch counts
under replay, and a host read inside a capture raising.

Needs an NVIDIA GPU and nvcc; every test skips without a card.  The file
imports no JAX, so on a machine without JAX it runs alone:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import copy
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import reconfigisp_tpu_torch as rt
from reconfigisp_tpu_torch import config, convert, pool
from reconfigisp_tpu_torch.ops import denoise
from reconfigisp_tpu_torch.ops.kernels import _build, _vjp
from reconfigisp_tpu_torch.ops.kernels import bilateral as kb
from reconfigisp_tpu_torch.ops.kernels import fastnlm as kf
from reconfigisp_tpu_torch.ops.kernels import median as km
from reconfigisp_tpu_torch.search import (
    DartsFtTrainer, DartsTrainer, IspTrainer)
from reconfigisp_tpu_torch.search.darts import (
    DartsConfig, init_darts_opt_state, make_darts_step)
from reconfigisp_tpu_torch.supernet import SuperNet
from reconfigisp_tpu_torch.utils import checkpoint, latency, losses

pytestmark = pytest.mark.cuda

_REPO = Path(__file__).resolve().parents[1]
_FLAGSHIP = "Bayer_01_Demosaic_03_sRGB_01_13_11"
_SLICE1 = "Bayer_01_Demosaic_03_sRGB_07_01_13_11"   # bilateral
_SLICE2 = "Bayer_01_Demosaic_03_sRGB_08_09_01_13_11"   # median, fast NLM
_KERNELS_OF = {_SLICE1: ("bilateral",), _SLICE2: ("median", "fastnlm")}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _case(shape, p, device):
    x = np.random.default_rng(31).uniform(0, 1, shape).astype(np.float32)
    return (torch.from_numpy(x).to(device),
            torch.as_tensor(np.asarray(p, np.float32), device=device))


def _spread(n):
    """n radii from 1 to 7, evenly: 1..7 for 7 images, 1, 3, 5, 7 for 4,
    1 and 7 for 2, 1 for one."""
    return [1 + 6 * i // max(n - 1, 1) for i in range(n)]


# the sRGB ops' input at detection geometry: the search step's
# (configs/yolo_search.yaml, 4 x 256^2) and step-2 training's
# (configs/yolo_isp.yaml, 2 x 512^2)
_DETECTION_SHAPES = [(4, 256, 256, 3), (2, 512, 512, 3)]
# and at SID's: step-2 training's crops (configs/SID_isp.yaml, 4 x 192^2,
# C = 3 as the sRGB ops take them, and C = 1) and the search step's
# (configs/SID_search.yaml, 4 x 48^2)
_SID_SHAPES = [(4, 192, 192, 3), (4, 192, 192, 1), (4, 48, 48, 3)]


def _bilateral_rows(sigma, n):
    """Radii spread over 1..7, one per image, distinct sigmas; or both
    sigma01 = `sigma`: 0 gives the most peaked weights (sigma 1), 1 the
    flattest (sigma 100)."""
    if sigma is None:
        return [[(r - 0.5) / 7.0, 0.1 * r, 0.05 + 0.1 * r] for r in _spread(n)]
    return [[(r - 0.5) / 7.0, sigma, sigma] for r in _spread(n)]


@pytest.mark.parametrize("sigma", [None, 0.0, 1.0])
@pytest.mark.parametrize("kind", ["uniform", "saturated", "constant"])
@pytest.mark.parametrize("shape", [
    (7, 64, 96, 3), (7, 40, 72, 1),
    (7, 520, 776, 3),                            # no block size divides it
    (8, 512, 512, 3), (8, 512, 512, 1),          # a serving chunk of tiles
    *_DETECTION_SHAPES, *_SID_SHAPES,
])
def test_kernel_matches_plain(cuda, shape, kind, sigma):
    """Radii spread over 1..7, one per image, within 2e-5 of the plain form:
    one exp2 per tap against two expf.  Saturated input, clamped from
    2 u - 0.5, has runs of exact 0.0 and 1.0; a constant frame gives every
    tap weight exp2 of its spatial term alone."""
    x, p = _case(shape, _bilateral_rows(sigma, shape[0]), cuda)
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
                                   (1, 520, 776, 3), (2, 41, 73, 1),
                                   (4, 512, 512, 3), (4, 256, 256, 1),
                                   *_DETECTION_SHAPES, *_SID_SHAPES])
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
    """Row 0 sets the block radius; search radii spread over 1..7 and
    decays vary."""
    return [[(block - 0.5) / 7.0 if i == 0 else 0.0,
             (s - 0.5) / 7.0, 0.05 + 0.13 * i]
            for i, s in enumerate(_spread(n))]


@pytest.mark.parametrize("shape", [(7, 48, 64, 3), (7, 40, 24, 1),
                                   (1, 520, 776, 3), (7, 512, 512, 3),
                                   (7, 256, 256, 1), *_DETECTION_SHAPES,
                                   *_SID_SHAPES])
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


def _plain(spec):
    """The op with its kernel swapped for its plain form."""
    if spec.name not in _PLAIN:
        return spec
    return dataclasses.replace(
        spec, apply=lambda x, p, w, f=_PLAIN[spec.name]: f(x, p))


def _plain_pipeline(pipe):
    """The pipeline with every kernel op on its plain form."""
    pipe.steps = [(name, _plain(spec)) for name, spec in pipe.steps]
    return pipe


def _launches():
    """Each kernel's forward launches since its count was last set."""
    return {name: mod.launches for name, mod in _MODULES.items()}


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
    x and params is the plain form's autograd.  Each op's backward kernel
    recomputes what the gradient needs as the plain form does (fast NLM's
    and the bilateral's y and the clip's mask in the plain form's
    arithmetic, the median's window median and its ties exactly) but sums
    the gradient in its own order, and fast NLM's and the bilateral's
    params gradient is a sum over every pixel and offset that cancels: gx
    and gp within 1e-4 of their largest reference value, at every frame
    size.  The median's params take no gradient on either path."""
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
    assert float((gx - wx).abs().max()) <= 1e-4 * float(wx.abs().max())
    if gp is not None:
        assert float((gp - wp).abs().max()) <= 1e-4 * float(wp.abs().max())


@pytest.mark.parametrize("arch", [_SLICE2, _SLICE1])
def test_isp_trainer_on_cuda_follows_the_cpu(cuda, arch):
    """Three IspTrainer steps on the median + fast-NLM path and on the
    bilateral's, on the card (one launch of each kernel a step) and on the
    CPU from the same state, TF32 off: losses within 1e-4 relative and
    logits within 1e-4 (the kernels' forward tolerances and cuDNN's order
    of sums, through Adam's scale-free step at lr 1e-3)."""
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
        kb.launches = km.launches = kf.launches = 0
        got = [card.train_step(batch)["loss"] for _ in range(3)]
        assert _launches() == {k: 3 if k in _KERNELS_OF[arch] else 0
                               for k in _MODULES}
        want = [cpu.train_step(batch)["loss"] for _ in range(3)]
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    np.testing.assert_allclose(got, want, rtol=1e-4)
    got_logits = convert.state_to_jax(card.pipeline)["logits"]
    for name, value in convert.state_to_jax(cpu.pipeline)["logits"].items():
        np.testing.assert_allclose(got_logits[name], value, atol=1e-4,
                                   err_msg=name)


# Step-2 training at configs/SID_isp.yaml's geometry, kernels against plain
# forms: steps a run.
_TRAIN_STEPS = 8
# Logits after _TRAIN_STEPS steps.  The backward is the plain form's on the
# same saved inputs, so the runs part only by the kernels' forward error (at
# most 2e-5 bilateral, 0 median, 5e-5 fast NLM) in values of order 0.1-1
# downstream: a relative change of at most about 5e-4 in each gradient.
# Adam's step is lr times a ratio of moments that a common scale of the
# gradients leaves unchanged, so that moves a logit by about lr 5e-4 = 5e-7
# a step, 4e-6 over 8 steps; the tolerance leaves 25x.
_TRAIN_LOGIT_TOL = 1e-4
# Each step's loss, relative to the loss.  The loss (about 0.07) is a mean
# over n = 4 x 192 x 192 x 3 = 442,368 squared residuals r (|r| about
# 0.26); the kernels' forward errors are differences of rounding order, of
# either sign, at most 5e-5, so even at that size everywhere they move the
# mean by about 2 x 5e-5 x 0.26 / sqrt(n) = 4e-8, 6e-7 of the loss; an
# error of 1e-4 that follows the residual's sign moves it by
# 2 x 1e-4 x 0.26 = 5e-5, 7e-4 of it.
_TRAIN_LOSS_RTOL = 1e-6


def _training_batch(device, n, size):
    """n pairs of size x size crops, made on the card from seed 0: a smooth
    BGR target, and as input its RGGB mosaic at half the light with noise,
    as a short exposure of SID's gives."""
    gen = torch.Generator(device=device).manual_seed(0)
    coarse = torch.rand((n, 3, size // 16, size // 16), generator=gen,
                        device=device)
    gt = torch.nn.functional.interpolate(
        coarse, size=(size, size), mode="bilinear",
        align_corners=False).permute(0, 2, 3, 1).contiguous()
    mosaic = torch.empty((n, size, size, 1), device=device)
    mosaic[:, 0::2, 0::2, 0] = gt[:, 0::2, 0::2, 2]   # R
    mosaic[:, 0::2, 1::2, 0] = gt[:, 0::2, 1::2, 1]   # G
    mosaic[:, 1::2, 0::2, 0] = gt[:, 1::2, 0::2, 1]   # G
    mosaic[:, 1::2, 1::2, 0] = gt[:, 1::2, 1::2, 0]   # B
    noise = torch.randn(mosaic.shape, generator=gen, device=device)
    return {"noisy": torch.clamp(0.5 * mosaic + 0.02 * noise, 0.0, 1.0),
            "gt": gt}


@pytest.mark.parametrize("arch", [None, _SLICE1, _SLICE2],
                         ids=["flagship", "slice 1", "slice 2"])
def test_isp_trainer_at_sid_isp_geometry_kernels_vs_plain(no_tf32, tmp_path,
                                                          arch):
    """configs/SID_isp.yaml's trainer (its options through config.parse,
    the bank's weights, the init logits; its own architecture, or a kernel
    path's) for _TRAIN_STEPS steps on one batch of its crops, TF32 off, with
    the kernels and with their plain forms from the same state: finite
    losses and a falling eval loss in both runs, each kernel of the path
    launched once a step with the kernels and never without, logits within
    _TRAIN_LOGIT_TOL and each step's loss within _TRAIN_LOSS_RTOL."""
    opt = config.parse(str(_REPO / "configs" / "SID_isp.yaml"),
                       root=str(tmp_path))
    data = opt["datasets"]["train"]
    arch = arch or opt["network_G"]["architecture"]
    batch = _training_batch(no_tf32, data["batch_size"], data["data_size"])
    runs = []
    for plain in (False, True):
        pipe = _bank_pipeline(arch, no_tf32,
                              config.network_uses_proxy(opt["network_G"]))
        trainer = IspTrainer(_plain_pipeline(pipe) if plain else pipe,
                             opt["train"])
        before = trainer.eval_loss(batch)
        kb.launches = km.launches = kf.launches = 0
        got = [trainer.train_step(batch)["loss"] for _ in range(_TRAIN_STEPS)]
        torch.cuda.synchronize()
        assert _launches() == {
            k: _TRAIN_STEPS if k in _KERNELS_OF.get(arch, ()) and not plain
            else 0 for k in _MODULES}
        assert all(math.isfinite(v) for v in got), got
        assert trainer.eval_loss(batch) < before
        runs.append((got, convert.state_to_jax(pipe)["logits"]))
    (got, got_logits), (want, want_logits) = runs
    np.testing.assert_allclose(got, want, rtol=_TRAIN_LOSS_RTOL, atol=0)
    for name, value in want_logits.items():
        np.testing.assert_allclose(got_logits[name], value, rtol=0,
                                   atol=_TRAIN_LOGIT_TOL, err_msg=name)


def _supernets(device):
    """SID_search's native slots (15 sRGB ops) at n_step 1 on the card: one
    net with the kernels, one with their plain forms, the same variables."""
    nets = []
    for plain in (False, True):
        net = SuperNet(1, 0.2, srgb_count=15, device=device)
        if plain:
            net.slots = [(slot, [_plain(s) for s in ops])
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
    relative, alphas within 1e-5, theta within 1e-6.  In each forward the
    kernels differ from the plain forms by rounding order (at most 2e-5
    bilateral, 5e-5 fast NLM, 0 median) in candidates weighted 1/15: an
    output error of about 1e-5 of either sign, which moves a mean loss over
    27,648 residuals by under 1e-6 of itself, and the alpha and theta
    gradients by about 1e-4 relative; Adam at lr 1e-4 and SGD at lr 1e-4
    then move an alpha by about 1e-8 and a theta by about 1e-8 a step, far
    inside the tolerances."""
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


# ------------------------------------------------------------- entry points

def _python(args, cwd, **env):
    """python `args` in a subprocess from `cwd`, the checkout first on
    PYTHONPATH, `env` added to this process's environment."""
    env = dict(os.environ, **env)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(_REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                        if p])
    return subprocess.run([sys.executable, *args], cwd=str(cwd), env=env,
                          capture_output=True, text=True, timeout=600)


def _cli(args, cwd):
    return _python(["-m", *args], cwd)


def _sid_records(root, n, h, w):
    """n SID pairs of uint16 14-bit raws and uint8 BGR GTs, seed 0."""
    from reconfigisp_tpu_torch.data.backends import PackedPairWriter
    rng = np.random.default_rng(0)
    with PackedPairWriter(str(root)) as wr:
        for i in range(n):
            gt = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            raw = rng.integers(0, 16384, (h, w), dtype=np.uint16)
            wr.add_pair(f"{i:05d}_0.1s", raw, f"{i:05d}_10s", gt)
    return str(root)


def test_train_cli_on_cuda_slice2(cuda, tmp_path):
    """python -m reconfigisp_tpu_torch.train on the card: configs/SID_isp.yaml
    with slice 2's architecture, the in-repo bank and packed records, 2
    steps, checkpointed."""
    opt = yaml.safe_load(open(_REPO / "configs" / "SID_isp.yaml"))
    opt["network_G"]["architecture"] = _SLICE2
    opt["datasets"]["train"].update(
        mode="SID_Records", dataroot=_sid_records(tmp_path / "rec", 4, 256,
                                                  320))
    opt["path"] = {"root": str(tmp_path), "pretrain_proxies": str(
        _REPO / "experiments" / "proxies" / "default.ckpt")}
    path = tmp_path / "isp.yaml"
    path.write_text(yaml.safe_dump(opt))
    r = _cli(["reconfigisp_tpu_torch.train", "--opt", str(path), "--niter",
              "2"], tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "'steps': 2" in r.stdout
    assert (tmp_path / "experiments" / "SID_isp" / "models"
            / "2_G.ckpt").is_file()


def test_test_cli_on_cuda_one_frame(cuda, tmp_path):
    """python -m reconfigisp_tpu_torch.test on the card: one 512x512 frame
    of slice 2, tiled at SID_test's 512 / 480, from a saved network; the
    output equals make_serving_fn's on the same weights within 1e-4 (both
    with PyTorch's default TF32 setting and 4 tiles a call)."""
    from reconfigisp_tpu_torch.deploy import make_serving_fn
    pipe = _bank_pipeline(_SLICE2, cuda)
    ckpt = checkpoint.save_network(str(tmp_path), "G", "t",
                                   convert.state_to_jax(pipe))
    opt = yaml.safe_load(open(_REPO / "configs" / "SID_test.yaml"))
    opt["network_G"]["architecture"] = _SLICE2
    opt["datasets"]["test"]["dataroot"] = _sid_records(tmp_path / "rec", 1,
                                                       512, 512)
    opt["path"] = {"root": str(tmp_path), "pretrain_model_G": ckpt}
    path = tmp_path / "test.yaml"
    path.write_text(yaml.safe_dump(opt))
    r = _cli(["reconfigisp_tpu_torch.test", "--opt", str(path)], tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "psnr_mean=" in r.stdout
    results = tmp_path / "results" / "SID_test"
    assert (results / "0000.png").is_file(), list(results.iterdir())
    from reconfigisp_tpu_torch.data import create_dataset
    sample = create_dataset(dict(opt["datasets"]["test"], is_train=False))[0]
    want = make_serving_fn(pipe, patch=512, stride=480, chunk=4,
                           device=cuda)(sample["noisy"][None])[0].cpu().numpy()
    # an 8-bit PNG, as the JAX package writes, read without cv2
    from reconfigisp_tpu_torch.utils import png
    got = png.read(str(results / "0000.png"))
    assert int(np.abs(got.astype(int) - np.clip(
        np.round(want * 255), 0, 255).astype(int)).max()) <= 1


@pytest.fixture
def no_tf32(cuda):
    """True f32 convolutions for the test's length."""
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield cuda
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


@pytest.mark.parametrize("kind", ["tiny_test", "yolov3"])
def test_yolo_forward_on_cuda_follows_the_cpu(no_tf32, kind):
    """YoloNet on the card against the CPU, one seeded init, TF32 off: every
    head within 1e-4 of its largest magnitude, the full 80-class graph at
    128x128.  75 f32 convolutions whose sums cuDNN and the CPU take in
    other orders, each a relative rounding of about 1e-7 of its output;
    the seeded init contracts the signal and the shortcuts add it back, so
    the heads' errors are relative: 1e-4 is about 100x a growth of 1e-7 a
    layer over 75 layers."""
    from reconfigisp_tpu_torch.yolo import cfg as ycfg
    from reconfigisp_tpu_torch.yolo.net import init_yolo
    blocks = (ycfg.yolov3_blocks(80) if kind == "yolov3"
              else ycfg.yolov3_tiny_test_blocks(2))
    size = 128 if kind == "yolov3" else 64
    cpu = init_yolo(blocks, torch.Generator().manual_seed(1))
    card = init_yolo(blocks, torch.Generator().manual_seed(1), device=no_tf32)
    x = torch.rand((2, size, size, 3), generator=torch.Generator()
                   .manual_seed(2))
    with torch.no_grad():
        got, want = card(x.to(no_tf32)), cpu(x)
    for (g, _, _), (w, _, _) in zip(got, want):
        assert g.shape == w.shape
        assert float((g.cpu() - w).abs().max()) <= 1e-4 * float(
            w.abs().max())


def test_yolo_criterion_gradient_on_cuda_follows_the_cpu(no_tf32):
    """The frozen tiny_test criterion's loss and input gradient on the card
    against the CPU, TF32 off: the loss within 1e-5 relative, the gradient
    within 1e-4 of its largest value (tests/test_torch_yolo.py's tolerances
    against JAX); several boxes on one cell, whose targets the card writes
    with unique indices."""
    from reconfigisp_tpu_torch.search.trainer import make_yolo_criterion
    from reconfigisp_tpu_torch.yolo import cfg as ycfg
    from reconfigisp_tpu_torch.yolo.net import init_yolo
    blocks = ycfg.yolov3_tiny_test_blocks(1)
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    lab = np.zeros((2, 8, 6), np.float32)
    lab[:, :5] = [1, 0, 0.5, 0.5, 0.25, 0.25]
    lab[:, :5, 2:4] += rng.uniform(0, 0.05, (2, 5, 2)).astype(np.float32)
    out = {}
    for dev in ("cpu", no_tf32):
        net = init_yolo(blocks, torch.Generator().manual_seed(3), device=dev)
        xt = torch.from_numpy(x).to(dev).requires_grad_()
        loss = make_yolo_criterion(net, 64)(xt, torch.from_numpy(lab).to(dev))
        (g,) = torch.autograd.grad(loss, xt)
        out[str(dev)] = (float(loss.detach()), g.cpu())
    (lc, gc), (lg, gg) = out["cpu"], out[str(no_tf32)]
    assert lg == pytest.approx(lc, rel=1e-5)
    assert float((gg - gc).abs().max()) <= 1e-4 * float(gc.abs().max())


# ------------------------------------------- custom ops and serving artifacts

@pytest.mark.parametrize("name", ["bilateral", "median", "fastnlm"])
def test_opcheck_on_cuda(cuda, name):
    """torch.library.opcheck of reconfigisp::<name> on the card: schema,
    autograd registration, the fake implementation against the kernel, and
    AOT autograd's forward and gradient against eager."""
    x, p = _case((2, 24, 40, 3), _grad_rows(name, 2), cuda)
    torch.library.opcheck(_MODULES[name].op, (x.requires_grad_(),
                                   p.requires_grad_(name != "median")))


@pytest.mark.parametrize("shape", [(3, 48, 40, 3), (2, 700, 24, 1)],
                         ids=["direct", "strip"])
@pytest.mark.parametrize("name", ["bilateral", "median", "fastnlm"])
def test_op_gradient_is_what_the_autograd_function_gave(cuda, name, shape):
    """Each op's backward returns its backward kernel's gradient, bit for
    bit, launching the forward kernel once; that is within 1e-4 of the
    largest value of _vjp.vjp's of the plain form on the saved inputs,
    direct and by strips (test_op_gradient_on_cuda_is_the_plain_forms
    gives the reason).  The median's params need no gradient."""
    x, p = _case(shape, _grad_rows(name, shape[0]), cuda)
    g = torch.randn(shape, generator=torch.Generator(cuda).manual_seed(6),
                    device=cuda)
    mod = _MODULES[name]
    needs = (True, name != "median")
    xs, ps = x.clone().requires_grad_(), p.clone().requires_grad_(needs[1])
    before = mod.launches
    out = getattr(denoise, name)(xs, ps)
    assert mod.launches == before + 1
    got = torch.autograd.grad(out, [xs, ps][:1 + needs[1]], g)
    want = _vjp.vjp(_PLAIN[name], mod.HALO, x, p, g, needs)
    kernel = mod.backward_kernel(x, p, g)[:2]
    torch.cuda.synchronize()
    assert len(got) == 1 + needs[1]
    for a, b, k in zip(got, want, kernel):
        assert torch.equal(a, k)
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


@pytest.mark.parametrize("shape,group", [((4, 48, 48, 3), None),
                                         ((3, 40, 56, 1), 7),
                                         ((2, 9, 200, 3), 60)],
                         ids=["search", "groups", "narrow"])
def test_fastnlm_backward_kernel_is_repeatable(cuda, shape, group):
    """The backward kernel has no float atomics and sums in orders fixed by
    the shapes: two calls, and a replay of a CUDA graph that captured a
    third, give the same gx and gp bit for bit, in one launch group at the
    search step's shape and in several (`group` offsets each) where the
    frame is larger; each within 1e-4 of the largest value of the plain
    form's gradient."""
    x, p = _case(shape, _grad_rows("fastnlm", shape[0]), cuda)
    g = torch.randn(shape, generator=torch.Generator(cuda).manual_seed(9),
                    device=cuda)
    group = group or kf.backward_group(x)
    backward = lambda: _build.launch_backward("fastnlm", x, p, g, 3, group)
    first, second = backward(), backward()
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        backward()
    torch.cuda.current_stream(cuda).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = backward()
    graph.replay()
    torch.cuda.synchronize()
    groups = -(-kf.OFFSETS // group)
    assert first[2] == second[2] == captured[2] == 3 * groups + 1
    for a, b, c in zip(first[:2], second[:2], captured[:2]):
        assert torch.equal(a, b) and torch.equal(a, c)
    want = _vjp.vjp(kf.fastnlm_plain, kf.HALO, x, p, g)
    for a, b in zip(first[:2], want):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


def test_fastnlm_backward_kernel_takes_the_clip_tie(cuda):
    """Patches of exact 1 and exact 0, where y is exactly 255 or 0 and the
    clip passes half the cotangent: the kernel recomputes y in the plain
    form's arithmetic, so its mask is the plain form's, and gx and gp stay
    within 1e-4 of their largest reference value."""
    x, p = _case((3, 48, 40, 3), _grad_rows("fastnlm", 3), cuda)
    x[:, :24, :20] = 1.0
    x[:, 24:, 20:] = 0.0
    g = torch.randn(x.shape, generator=torch.Generator(cuda).manual_seed(10),
                    device=cuda)
    xs, ps = x.clone().requires_grad_(), p.clone().requires_grad_()
    out = kf.fastnlm_plain(xs, ps)
    assert bool(((out == 0) | (out == 1)).any())
    want = torch.autograd.grad(out, (xs, ps), g)
    got = kf.backward_kernel(x, p, g)[:2]
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


@pytest.mark.parametrize("shape", [(4, 48, 48, 3), (2, 9, 200, 3),
                                   (1, 700, 24, 1)],
                         ids=["search", "narrow", "tall"])
def test_bilateral_backward_kernel_is_repeatable(cuda, shape):
    """The bilateral's backward kernel has no float atomics and sums in
    orders fixed by the shapes: two calls, and a replay of a CUDA graph that
    captured a third, give the same gx and gp bit for bit, 3 launches each,
    at the search step's shape, a frame 9 rows high and one above
    _vjp.DIRECT_ROWS; each within 1e-4 of the largest value of the plain
    form's gradient."""
    x, p = _case(shape, _grad_rows("bilateral", shape[0]), cuda)
    g = torch.randn(shape, generator=torch.Generator(cuda).manual_seed(11),
                    device=cuda)
    backward = lambda: kb.backward_kernel(x, p, g)
    first, second = backward(), backward()
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        backward()
    torch.cuda.current_stream(cuda).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = backward()
    graph.replay()
    torch.cuda.synchronize()
    assert first[2] == second[2] == captured[2] == 3
    for a, b, c in zip(first[:2], second[:2], captured[:2]):
        assert torch.equal(a, b) and torch.equal(a, c)
    want = _vjp.vjp(kb.bilateral_plain, kb.HALO, x, p, g)
    for a, b in zip(first[:2], want):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    assert torch.equal(first[1][:, 0], torch.zeros_like(first[1][:, 0]))


def test_bilateral_backward_kernel_takes_the_clip_tie(cuda):
    """Patches of exact 1 and exact 0, where y is exactly 255 or 0 and the
    clip passes half the cotangent: the kernel recomputes y in the plain
    form's arithmetic, so its mask is the plain form's, and gx and gp stay
    within 1e-4 of their largest reference value."""
    x, p = _case((3, 48, 40, 3), _grad_rows("bilateral", 3), cuda)
    x[:, :24, :20] = 1.0
    x[:, 24:, 20:] = 0.0
    g = torch.randn(x.shape, generator=torch.Generator(cuda).manual_seed(12),
                    device=cuda)
    xs, ps = x.clone().requires_grad_(), p.clone().requires_grad_()
    out = kb.bilateral_plain(xs, ps)
    assert bool(((out == 0) | (out == 1)).any())
    want = torch.autograd.grad(out, (xs, ps), g)
    got = kb.backward_kernel(x, p, g)[:2]
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


@pytest.mark.parametrize("shape", [(4, 48, 48, 3), (2, 9, 200, 3),
                                   (1, 700, 24, 1)],
                         ids=["search", "narrow", "tall"])
def test_median_backward_kernel_is_repeatable(cuda, shape):
    """The median's backward kernel has no float atomics and sums in orders
    fixed by the shapes: two calls, and the replay of one CUDA graph that
    captured a third at radius 4 (the selection networks), give the same
    gx bit for bit, 2 launches each, at radii 4, 6 and 7 (the bisection)
    and 1, the radius changed on the device between replays; each within
    1e-4 of the largest value of the plain form's gradient, and gp exactly
    0, at the search step's shape, a frame 9 rows high and one above
    _vjp.DIRECT_ROWS."""
    x, p = _case(shape, _grad_rows("median", shape[0]), cuda)
    g = torch.randn(shape, generator=torch.Generator(cuda).manual_seed(13),
                    device=cuda)
    p.fill_((4 - 0.5) / 7.0)
    backward = lambda: km.backward_kernel(x, p, g)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        backward()
    torch.cuda.current_stream(cuda).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = backward()
    for r in (4, 6, 7, 1):
        p.fill_((r - 0.5) / 7.0)
        first, second = backward(), backward()
        graph.replay()
        torch.cuda.synchronize()
        assert first[2] == second[2] == captured[2] == 2
        for a, b, c in zip(first[:2], second[:2], captured[:2]):
            assert torch.equal(a, b) and torch.equal(a, c), r
        assert torch.equal(first[1], torch.zeros_like(first[1]))
        want = _vjp.vjp(km.median_plain, km.HALO, x, p, g, (True, False))[0]
        assert float((first[0] - want).abs().max()) <= 1e-4 * float(
            want.abs().max()), r


@pytest.mark.parametrize("radius", [2, 6])
def test_median_backward_kernel_takes_the_ties(cuda, radius):
    """Patches of exact 1 and exact 0 wider than the window, where every
    tap ties (c = K) and the clip passes half the cotangent, a patch of +0
    and -0 mixed, which tie, and a patch of eighths, whose windows tie in
    runs: the kernel's gx within 1e-4 of the plain form's largest gradient
    value, at a network radius and a bisection radius."""
    x, p = _case((3, 48, 40, 3), [[(radius - 0.5) / 7.0]] * 3, cuda)
    x[:, :24, :20] = 1.0
    x[:, 24:, 20:] = 0.0
    x[:, :24, 20:] = torch.floor(x[:, :24, 20:] * 9.0) / 8.0
    signs = torch.rand(x[:, 24:, :20].shape, device=cuda) < 0.5
    x[:, 24:, :20] = torch.where(signs, -0.0, 0.0)
    assert bool((torch.signbit(x) & (x == 0)).any())
    g = torch.randn(x.shape, generator=torch.Generator(cuda).manual_seed(14),
                    device=cuda)
    xs = x.clone().requires_grad_()
    out = km.median_plain(xs, p)
    assert bool(((out == 0) | (out == 1)).any())
    want = torch.autograd.grad(out, xs, g)[0]
    got = km.backward_kernel(x, p, g)
    torch.cuda.synchronize()
    assert float((got[0] - want).abs().max()) <= 1e-4 * float(
        want.abs().max())
    assert torch.equal(got[1], torch.zeros_like(got[1]))


@functools.lru_cache(maxsize=1)
def _bank():
    """The in-repo module bank."""
    return checkpoint.load_network(
        str(_REPO / "experiments" / "proxies" / "default.ckpt"))


def _bank_pipeline(arch, device, use_proxy=False):
    pipe = rt.Pipeline(arch, use_proxy, device=device)
    return pipe.load_state(convert.state_from_bank(_bank(), pipe))


def test_artifact_exported_on_cuda_equals_serving_fn(no_tf32):
    """Slice 2 exported on the card with the tiled engine at 2x512x512x1
    (patch 256, stride 224, chunk 4): the loaded artifact within 1e-4 of
    make_serving_fn, the same launches of each kernel."""
    from reconfigisp_tpu_torch import deploy
    cuda = no_tf32
    pipe = _bank_pipeline(_SLICE2, cuda)
    tiling = dict(patch=256, stride=224, chunk=4)
    loaded = deploy.load_pipeline(deploy.export_pipeline(
        pipe, (2, 512, 512, 1), **tiling))
    x = torch.rand((2, 512, 512, 1), device=cuda,
                   generator=torch.Generator(cuda).manual_seed(7))
    counts = []
    outs = []
    for fn in (loaded, deploy.make_serving_fn(pipe, **tiling)):
        km.launches = kf.launches = kb.launches = 0
        outs.append(fn(x))
        counts.append((kb.launches, km.launches, kf.launches))
    torch.cuda.synchronize()
    assert counts[0] == counts[1] == (0, 3, 3)
    assert float((outs[0] - outs[1]).abs().max()) <= 1e-4


@pytest.mark.parametrize("arch", [_SLICE1, _SLICE2])
def test_artifact_exported_on_cpu_runs_on_cuda(no_tf32, arch):
    """An artifact traced on the CPU, loaded onto the card (its constants
    and device arguments moved), launches the kernels and agrees with
    make_serving_fn on the card within 1e-4."""
    from reconfigisp_tpu_torch import deploy
    cuda = no_tf32
    tiling = dict(patch=64, stride=56, chunk=4)
    blob = deploy.export_pipeline(_bank_pipeline(arch, "cpu"),
                                  (1, 176, 232, 1), **tiling)
    loaded = deploy.load_pipeline(blob)
    assert loaded.device.type == "cuda"
    x = torch.rand((1, 176, 232, 1), device=cuda,
                   generator=torch.Generator(cuda).manual_seed(8))
    kb.launches = km.launches = kf.launches = 0
    got = loaded(x)
    torch.cuda.synchronize()
    launches = {"bilateral": kb.launches, "median": km.launches,
                "fastnlm": kf.launches}
    assert got.device.type == "cuda"
    assert launches == {k: 3 if k in _KERNELS_OF[arch] else 0
                        for k in launches}
    want = deploy.make_serving_fn(_bank_pipeline(arch, cuda), **tiling)(x)
    assert float((got - want).abs().max()) <= 1e-4


# A Sony frame of SID (12.1 MP) served at configs/SID_test.yaml's tiles,
# 8 a chunk
_FRAME = (2848, 4256)
_FRAME_TILING = dict(patch=512, stride=480, chunk=8)


def _frame_chunks():
    """Launches of each kernel of the path a served batch of frames: one a
    chunk of tiles."""
    from reconfigisp_tpu_torch.parallel.tiling import tile_positions
    tiles = math.prod(len(tile_positions(n, _FRAME_TILING["patch"],
                                         _FRAME_TILING["stride"]))
                      for n in _FRAME)
    return math.ceil(tiles / _FRAME_TILING["chunk"])


@pytest.mark.parametrize("arch", [_SLICE1, _SLICE2],
                         ids=["slice 1", "slice 2"])
def test_frames_served_on_cuda_kernels_vs_plain(no_tf32, arch):
    """Two frames through make_serving_fn at frame size, TF32 off, the
    counts set to 0 first: the output's shape, finite and in [0, 1], each
    kernel of the path launched once a chunk (batches of 16 tiles of 512^2,
    the last of 12), and within 1e-4 of the same serving on the plain
    forms."""
    from reconfigisp_tpu_torch import deploy
    cuda = no_tf32
    x = torch.rand((2, *_FRAME, 1), device=cuda,
                   generator=torch.Generator(cuda).manual_seed(0))
    serve = deploy.make_serving_fn(_bank_pipeline(arch, cuda),
                                   device=cuda, **_FRAME_TILING)
    kb.launches = km.launches = kf.launches = 0
    got = serve(x)
    torch.cuda.synchronize()
    assert _launches() == {k: _frame_chunks() if k in _KERNELS_OF[arch]
                           else 0 for k in _MODULES}
    assert tuple(got.shape) == (2, *_FRAME, 3)
    assert bool(torch.isfinite(got).all())
    assert 0.0 <= float(got.min()) and float(got.max()) <= 1.0
    want = deploy.make_serving_fn(
        _plain_pipeline(_bank_pipeline(arch, cuda)), device=cuda,
        **_FRAME_TILING)(x)
    assert float((got - want).abs().max()) <= 1e-4


# python -c ARTIFACT FRAME OUT: load an artifact with deploy alone, TF32
# off, serve the saved frame on the card and save the output; print, last,
# the launches (counted from 0 at the process's start) and the modules of
# the JAX package, the pipeline or the op registry it imported
_SERVE_ARTIFACT = """
import json, sys
import numpy as np
import torch
from reconfigisp_tpu_torch import deploy
from reconfigisp_tpu_torch.ops.kernels import bilateral, fastnlm, median
torch.backends.cudnn.allow_tf32 = False
served = deploy.load_pipeline(sys.argv[1])
y = served(torch.from_numpy(np.load(sys.argv[2])).to(served.device))
np.save(sys.argv[3], y.cpu().numpy())
print(json.dumps({
    "launches": {"bilateral": bilateral.launches, "median": median.launches,
                 "fastnlm": fastnlm.launches},
    "imported": sorted(m for m in sys.modules
                       if m.split(".")[0] in ("jax", "reconfigisp_tpu")
                       or m in ("reconfigisp_tpu_torch.pipeline",
                                "reconfigisp_tpu_torch.registry"))}))
"""


@pytest.mark.parametrize("storage", ["f32", "bf16"])
def test_tiled_artifact_at_frame_size_in_a_fresh_process(no_tf32, tmp_path,
                                                         storage):
    """Slice 2 exported with the tiled engine at 1 x 2848 x 4256 x 1 with
    `storage` CNN storage, saved, then loaded and served in a process that
    imports deploy alone: within 1e-4 of make_serving_fn in this process
    under the same storage, the same launches, one a chunk, and neither JAX
    nor the pipeline nor the registry imported there."""
    from reconfigisp_tpu_torch import deploy, precision
    cuda = no_tf32
    pipe = _bank_pipeline(_SLICE2, cuda)
    path = tmp_path / f"slice2_{storage}.rispt"
    deploy.save_artifact(str(path), deploy.export_pipeline(
        pipe, (1, *_FRAME, 1), storage=storage, **_FRAME_TILING))
    x = torch.rand((1, *_FRAME, 1), generator=torch.Generator().manual_seed(9))
    np.save(tmp_path / "x.npy", x.numpy())
    with precision.cnn_storage(storage):
        kb.launches = km.launches = kf.launches = 0
        want = deploy.make_serving_fn(pipe, device=cuda,
                                      **_FRAME_TILING)(x)
        torch.cuda.synchronize()
        direct = _launches()
    r = _python(["-c", _SERVE_ARTIFACT, str(path), str(tmp_path / "x.npy"),
                 str(tmp_path / "y.npy")], _REPO, NVIDIA_TF32_OVERRIDE="0")
    assert r.returncode == 0, r.stderr[-3000:]
    run = json.loads(r.stdout.strip().splitlines()[-1])
    assert run["imported"] == []
    assert run["launches"] == direct == {
        "bilateral": 0, "median": _frame_chunks(), "fastnlm": _frame_chunks()}
    got = np.load(tmp_path / "y.npy")
    assert got.shape == (1, *_FRAME, 3) and np.isfinite(got).all()
    assert float(np.abs(got - want.cpu().numpy()).max()) <= 1e-4


@pytest.mark.parametrize("arch,batch", [(_FLAGSHIP, "b"), (_SLICE1, 1)],
                         ids=["flagship", "slice 1"])
def test_whole_frame_artifact_at_frame_size_on_cuda(no_tf32, arch, batch):
    """Exported whole-frame at frame size (the flagship with a symbolic
    batch, served at 1 and 2 frames; slice 1 at 1) and served in this
    process, the counts set to 0 first: the bilateral launched once a call
    where the path has it, and within 1e-4 of make_serving_fn."""
    from reconfigisp_tpu_torch import deploy
    cuda = no_tf32
    pipe = _bank_pipeline(arch, cuda)
    served = deploy.load_pipeline(deploy.export_pipeline(
        pipe, (batch, *_FRAME, 1)), device=cuda)
    serve = deploy.make_serving_fn(pipe, device=cuda)
    for n in (1, 2) if batch == "b" else (1,):
        x = torch.rand((n, *_FRAME, 1), device=cuda,
                       generator=torch.Generator(cuda).manual_seed(n))
        kb.launches = km.launches = kf.launches = 0
        got = served(x)
        torch.cuda.synchronize()
        assert _launches() == {k: 1 if k in _KERNELS_OF.get(arch, ()) else 0
                               for k in _MODULES}
        assert tuple(got.shape) == (n, *_FRAME, 3)
        assert float((got - serve(x)).abs().max()) <= 1e-4


# ---------------------------------------------------------------- the zoo

def _zoo_cases():
    """(domain, index, use_proxy) of every op of the three pools, native
    and, where it has one, proxy."""
    for domain in ("bayer", "demosaic", "srgb"):
        for idx, spec in enumerate(pool(domain), start=1):
            for use_proxy in (False, True)[:1 + (spec.proxy_apply
                                                 is not None)]:
                yield pytest.param(domain, idx, use_proxy, id=(
                    f"{domain}_{spec.name}" + "_proxy" * use_proxy))


def _zoo_arch(domain, idx):
    """A short pipeline around one op of `domain`."""
    return {"bayer": f"Bayer_{idx:02d}_Demosaic_01_sRGB_10",
            "demosaic": f"Bayer_02_Demosaic_{idx:02d}_sRGB_10",
            "srgb": f"Bayer_02_Demosaic_01_sRGB_{idx:02d}"}[domain]


@pytest.mark.parametrize("domain,idx,use_proxy", _zoo_cases())
def test_zoo_op_on_cuda_follows_the_cpu(no_tf32, domain, idx, use_proxy):
    """Every op in a pipeline of its own, with the bank's weights, on the
    card (the hand kernels where the op is one) against the same pipeline
    on the CPU (their plain forms), TF32 off: within 1e-4, the convolutions'
    sums reordered and the kernels' own rounding (at most 5e-5)."""
    arch = _zoo_arch(domain, idx)
    x = torch.rand((2, 64, 96, 1), generator=torch.Generator().manual_seed(3))
    with torch.inference_mode():
        got = _bank_pipeline(arch, no_tf32, use_proxy)(x.to(no_tf32))
        want = _bank_pipeline(arch, "cpu", use_proxy)(x)
    assert float((got.cpu() - want).abs().max()) <= 1e-4


@pytest.mark.parametrize("use_proxies", [False, True],
                         ids=["native", "proxy"])
def test_latency_table_on_cuda(cuda, use_proxies):
    """utils/latency.calibrate times every op with CUDA events on the card:
    a finite, positive ms/MP each, the windowed ops' kernels launched 5
    times each (2 untimed runs, 3 timed) where the table is native."""
    kb.launches = km.launches = kf.launches = 0
    table = latency.calibrate(size=64, batch=1, use_proxies=use_proxies,
                              device=cuda)
    assert {"bilateral", "median", "fastnlm"} <= set(table)
    assert all(math.isfinite(v) and v > 0 for v in table.values()), table
    assert _launches() == {k: 0 if use_proxies else 5 for k in _MODULES}


# ------------------------------------------------------------- CUDA graphs

# SID_search's slots (3 of the first 9 sRGB ops: the three kernels) at its
# crop geometry; a MultiStepLR milestone at step 2 moves the lr within a run
_GRAPH_OPT = {"lr_G": 1e-2, "momentum_G": 0.9, "lr_meta": 1e-2, "beta1": 0.9,
              "beta2": 0.99, "pixel_criterion": "l2",
              "lr_scheme": "MultiStepLR", "lr_steps": [2], "lr_gamma": 0.5}


def _graph_trainer(device, k=1, order=2, **kw):
    return DartsTrainer(SuperNet(3, 0.2, srgb_count=9, device=device),
                        dict(_GRAPH_OPT, steps_per_dispatch=k,
                             darts_order=order), **kw)


def _graph_pairs(n):
    rng = np.random.default_rng(35)
    mk = lambda c: rng.uniform(0.05, 0.95, (4, 48, 48, c)).astype(np.float32)
    return [({"noisy": mk(1), "gt": mk(3)}, {"noisy": mk(1), "gt": mk(3)})
            for _ in range(n)]


def _assert_trainers_agree(got, want):
    """Alphas within 1e-5, theta within 1e-6 and the optimiser state within
    1e-3 of its largest value (test_darts_step_on_cuda_kernels_vs_plain
    gives the alphas' and theta's reasons; the state sums the step's
    gradients, Adam's v their squares, whose relative error is at most
    about 1e-4 and 2e-4: 1e-3 leaves 5-10x); the same kernels on the same
    inputs, so 0 is expected up to rounding."""
    for slot, a in want.variables["alphas"].items():
        assert float((got.variables["alphas"][slot] - a).abs().max()) <= 1e-5
        for op, t in want.variables["theta"][slot].items():
            assert float((got.variables["theta"][slot][op] - t).abs().max()
                         ) <= 1e-6, (slot, op)
    for key in ("momentum", "adam_m", "adam_v"):
        flat = lambda d: [v for x in d.values() for v in (
            flat(x) if isinstance(x, dict) else [x])]
        for a, b in zip(flat(got.opt_state[key]), flat(want.opt_state[key])):
            assert float((a - b).abs().max()) <= 1e-3 * max(
                float(b.abs().max()), 1e-30), key
    assert int(got.opt_state["adam_t"]) == int(want.opt_state["adam_t"])


def _eager(trainer, pairs, record=False):
    """The trainer's step function run eagerly as search_step schedules
    it, each step's intermediates recorded into an ft trainer's memory with
    `record` -> the logs as floats."""
    logs = []
    for tb, vb in pairs:
        trainer.step_idx += 1
        batch = {k: trainer._tensor(v)
                 for k, v in trainer.step_batch(tb, vb).items()}
        trainer.variables, trainer.opt_state, out = trainer._step(
            trainer.variables, trainer.opt_state, batch,
            trainer.schedule(trainer.step_idx))
        trainer._last_aux = {k: out.pop(k) for k in list(out)
                             if k.startswith("_")}
        logs.append({k: float(v) for k, v in out.items()})
        if record:
            trainer.record_intermediates()
    return logs


def _assert_logs_agree(got, want):
    """Each step's losses within 1e-5 relative."""
    for a, b in zip(got, want, strict=True):
        for k in ("loss", "val_loss"):
            assert abs(a[k] - b[k]) <= 1e-5 * abs(b[k]), (k, a, b)


@pytest.mark.parametrize("order", [2, 1])
def test_captured_step_equals_eager_step(cuda, order):
    """3 steps as replays of the captured graph against the eager step
    from the same start, second and first order, TF32 off: the same
    launches of each kernel, counted through the replays; each step's
    losses within 1e-5 relative, and the variables and state
    (_assert_trainers_agree)."""
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        pairs = _graph_pairs(3)
        eager = _graph_trainer(cuda, order=order)
        captured = _graph_trainer(cuda, order=order)
        kb.launches = km.launches = kf.launches = 0
        want = _eager(eager, pairs)
        eager_launches = _launches()
        kb.launches = km.launches = kf.launches = 0
        got = [captured.search_step(tb, vb) for tb, vb in pairs]
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert captured.graph is not None and eager.graph is None
    assert _launches() == eager_launches and min(eager_launches.values()) > 0
    _assert_logs_agree(got, want)
    _assert_trainers_agree(captured, eager)


def test_k3_trainer_equals_k1_trainer(cuda):
    """steps_per_dispatch 3 over 6 steps and 1 step of a flush against
    K = 1 over the same 7: the K-step trainer's state after each dispatch
    and its logs are K = 1's; every step launched each kernel 15 times (3
    slots x 5 passes), counted through the replays."""
    pairs = _graph_pairs(7)
    runs = {}
    for k in (1, 3):
        trainer = _graph_trainer(cuda, k)
        kb.launches = km.launches = kf.launches = 0
        logs = [trainer.search_step(tb, vb) for tb, vb in pairs]
        trainer.flush()
        torch.cuda.synchronize()
        runs[k] = (trainer, logs, (kb.launches, km.launches, kf.launches))
    (one, logs1, count1), (three, logs3, count3) = runs[1], runs[3]
    assert count1 == count3 == (15 * 7,) * 3
    assert logs3[:2] == [logs3[0]] * 2 and logs3[3:5] == [logs3[2]] * 2
    _assert_logs_agree([logs3[2], logs3[5], three.last_logs],
                       [logs1[2], logs1[5], one.last_logs])
    _assert_trainers_agree(three, one)


# a replay's launches of one step at the crops' 4 x 48^2 x 3.  The median's
# params take no gradient, so its backward runs only where its input needs
# one: not in the first slot in the two passes that differentiate theta
# alone (the virtual step and the update), 13 of its 15 applications.
_REPLAY = {"bilateral": 15, "median": 15, "fastnlm": 15,
           "fastnlm.backward": 15 * 4, "bilateral.backward": 15 * 3,
           "median.backward": 13 * 2}


def test_launch_counts_under_replay(cuda):
    """The capture's launches are a replay's (15 a kernel; fast NLM's
    backward kernel 15 applications of 4 launches, one group at the crops'
    4 x 48^2 x 3; the bilateral's 15 of 3; the median's 13 of 2), added to
    the kernels' counts on each replay; the warm-up step's are kept apart,
    so the counts hold from the first step on."""
    trainer = _graph_trainer(cuda)
    pairs = _graph_pairs(2)
    kb.launches = km.launches = kf.launches = kf.backward_launches = 0
    kb.backward_launches = km.backward_launches = 0
    trainer.search_step(*pairs[0])
    assert (kb.launches, km.launches, kf.launches) == (15, 15, 15)
    assert (kf.backward_launches, kb.backward_launches,
            km.backward_launches) == (15 * 4, 15 * 3, 13 * 2)
    trainer.search_step(*pairs[1])
    assert (kb.launches, km.launches, kf.launches) == (30, 30, 30)
    assert (kf.backward_launches, kb.backward_launches,
            km.backward_launches) == (30 * 4, 30 * 3, 26 * 2)
    assert trainer.graph.launches == trainer.graph.warmup_launches == _REPLAY


@pytest.mark.parametrize("name", ["bilateral", "median", "fastnlm"])
def test_capture_safe_routes_equal_host_routes_on_cuda(cuda, name):
    """Each plain form's capture-safe route against its host-read route on
    the card, value and both gradients bit for bit: radii 1-7 (fast NLM:
    the block radius, with per-image search radii 1, 4 and 7); the
    capture-safe fast NLM divides by its block size as torch divides a CUDA
    tensor by a number."""
    plain = _PLAIN[name]
    for r in range(1, 8):
        x, p = _case((3, 48, 40, 3), _grad_rows(name, 3), cuda)
        if name == "median":
            p[0, 0] = (r - 0.5) / 7.0
        elif name == "fastnlm":
            p[0, 0] = (r - 0.5) / 7.0
            p[:, 1] = torch.tensor([0.5, 3.5, 6.5], device=cuda) / 7.0
        else:
            p[:, 0] = torch.tensor([r, max(1, r - 2), 1.0],
                                   device=cuda).sub(0.5) / 7.0
        g = torch.rand(x.shape, device=cuda,
                       generator=torch.Generator(device=cuda).manual_seed(r))
        got = []
        for static in (False, True):
            xs, ps = x.clone().requires_grad_(), p.clone().requires_grad_()
            y = plain(xs, ps, static=static)
            got.append((y.detach(),) + torch.autograd.grad(
                y, (xs, ps), g, allow_unused=True))
        for a, b in zip(*got):
            assert (a is None) == (b is None)
            assert a is None or torch.equal(a, b), (name, r)


def test_host_read_inside_capture_raises(cuda):
    """Nothing falls back: a plain form's host-read route inside a capture
    raises, and a step that reads a tensor on the host fails its capture,
    naming the op, instead of running eagerly."""
    x, p = _case((2, 48, 48, 3), [[0.3], [0.3]], cuda)
    km.median_plain(x, p, static=True)   # warm: the capture-safe route
    with pytest.raises(RuntimeError):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            km.median_plain(x, p, static=False)
    torch.cuda.synchronize()

    net = SuperNet(1, 0.2, srgb_count=9, device=cuda)

    def forward(theta, alphas, omega, img):
        y, aux = net({"theta": theta, "alphas": alphas, "omega": omega},
                     img * float(img.mean() > 0), return_aux=True)
        return y, aux["latency"]

    trainer = DartsTrainer(net, _GRAPH_OPT, forward=forward)
    with pytest.raises(RuntimeError, match="_local_scalar_dense"):
        trainer.search_step(*_graph_pairs(1)[0])
    torch.cuda.synchronize()


def _captured(trainer, pairs, record=False):
    """search_step on each pair, each dispatch's intermediates recorded
    into an ft trainer's memory with `record`, then a flush -> the logs."""
    logs = []
    for tb, vb in pairs:
        logs.append(trainer.search_step(tb, vb))
        if record:
            trainer.record_intermediates()
    trainer.flush()
    return logs


def _assert_memories_agree(got, want):
    """An ft trainer's replayed memory against eager's: within 1e-5 (the
    alphas' tolerance: the same passes on the same inputs)."""
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-5


# configs/planted_search_ft.yaml's tuning: its memory and Adam steps a round
_FT = {"memory_size": 100, "ft_steps": 4}


def _ft_trainer(device, k=1):
    """The proxy-tuning trainer over _graph_trainer's slots with proxies,
    the bank's proxies installed, as a run of planted_search_ft.yaml
    starts."""
    trainer = DartsFtTrainer(
        SuperNet(3, 0.2, use_proxies=True, srgb_count=9, device=device),
        dict(_GRAPH_OPT, steps_per_dispatch=k, manual_seed=10), _FT)
    trainer.load_pretrained(_bank())
    return trainer


def _ft_shadow(trainer, omega=None):
    """An ft trainer for eager steps that holds `trainer`'s variables (with
    `omega`'s modules if given), DARTS state and step."""
    shadow = _ft_trainer(trainer.net.device)
    variables = dict(trainer.variables)
    if omega is not None:
        variables["omega"] = omega
    shadow._assign(variables, trainer.opt_state)
    shadow.step_idx = trainer.step_idx
    return shadow


@pytest.mark.parametrize("k", [1, 2])
def test_ft_trainer_captured_around_a_tuning_round(no_tf32, k):
    """The proxy-tuning trainer captured at K steps a dispatch, TF32 off:
    2 steps, each recorded, against eager steps (the replayed memory
    within 1e-5 of eager's); one finetune_proxies, whose targets launch
    each kernel ft_steps times and whose last losses are finite, one per
    tuned proxy; then 2 more steps against eager steps from the trainer's
    own tuned state.  The replays read the tuned proxies: eager steps from
    the same state with the untuned ones part from them by more than 10x
    the loss tolerance.  Runs are compared from one state after the
    tuning, not across it: its Adam moves a weight whose gradient is near
    its eps by up to lr a step on rounding alone."""
    pairs = _graph_pairs(4)
    first, second = pairs[:2], pairs[2:]
    eager, trainer = _ft_trainer(no_tf32), _ft_trainer(no_tf32, k)
    want = _eager(eager, first, record=True)
    got = _captured(trainer, first, record=True)
    assert trainer.graph is not None
    _assert_logs_agree(got[k - 1::k], want[k - 1::k])
    _assert_trainers_agree(trainer, eager)
    _assert_memories_agree(trainer.ft_data, eager.ft_data)

    untuned = {name: copy.deepcopy(m)
               for name, m in trainer.variables["omega"].items()}
    kb.launches = km.launches = kf.launches = 0
    tuned = trainer.finetune_proxies()
    torch.cuda.synchronize()
    assert _launches() == {name: _FT["ft_steps"] for name in _MODULES}
    assert sorted(tuned) == sorted(f"ft_{s.name}" for s in trainer.ft_ops)
    assert all(math.isfinite(v) for v in tuned.values()), tuned

    tuned_ref = _ft_shadow(trainer)
    want = _eager(tuned_ref, second, record=True)
    stale = _eager(_ft_shadow(trainer, untuned), second)
    got = _captured(trainer, second, record=True)
    assert max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
               for a, b in zip(stale, want)) > 10 * 1e-5
    _assert_logs_agree(got[k - 1::k], want[k - 1::k])
    _assert_trainers_agree(trainer, tuned_ref)
    _assert_memories_agree(trainer.ft_data[-len(tuned_ref.ft_data):],
                           tuned_ref.ft_data)


def test_darts_yolo_captured_step_equals_eager_step(no_tf32):
    """The search step on darts_yolo's objective (a frozen detector's loss
    on labels, in place of l2) captured against eager from one start, TF32
    off: 2 steps, each kernel launched 15 times a step either way; losses
    within 1e-5 relative and alphas within 1e-5; theta within 1e-3 of its
    largest move, since the detection loss's gradients are large (of order
    1e3-1e4) and the parting scales with the move.  The seeded detector's
    loss is almost flat, so the DARTS state's moments are rounding-sized in
    places and are not held."""
    from reconfigisp_tpu_torch.search.trainer import make_yolo_criterion
    from reconfigisp_tpu_torch.yolo import cfg as ycfg
    from reconfigisp_tpu_torch.yolo.net import init_yolo
    detector = init_yolo(ycfg.yolov3_tiny_test_blocks(1),
                         torch.Generator().manual_seed(3), device=no_tf32)
    criterion = make_yolo_criterion(detector, 64)
    rng = np.random.default_rng(37)

    def batch():
        label = np.zeros((4, 8, 6), np.float32)
        label[:, :3] = [1, 0, 0.5, 0.5, 0.25, 0.25]
        label[:, :3, 2:4] += rng.uniform(-0.2, 0.2, (4, 3, 2))
        return {"noisy": rng.uniform(0.05, 0.95, (4, 64, 64, 1)).astype(
            np.float32), "label": label}

    pairs = [(batch(), batch()) for _ in range(2)]
    start, eager, captured = (
        _graph_trainer(no_tf32, criterion=criterion, target_key="label")
        for _ in range(3))
    kb.launches = km.launches = kf.launches = 0
    want = _eager(eager, pairs)
    eager_launches = _launches()
    kb.launches = km.launches = kf.launches = 0
    got = _captured(captured, pairs)
    torch.cuda.synchronize()
    assert captured.graph is not None
    assert _launches() == eager_launches == {k: 30 for k in _MODULES}
    _assert_logs_agree(got, want)
    move = max(float((t - start.variables["theta"][slot][op]).abs().max())
               for slot, ops in eager.variables["theta"].items()
               for op, t in ops.items())
    for slot, a in eager.variables["alphas"].items():
        assert float((captured.variables["alphas"][slot] - a).abs().max()
                     ) <= 1e-5
        for op, t in eager.variables["theta"][slot].items():
            assert float((captured.variables["theta"][slot][op] - t)
                         .abs().max()) <= 1e-3 * move, (slot, op)


@pytest.fixture
def nccl(no_tf32, tmp_path):
    """A process group of one NCCL rank on the card, TF32 off."""
    import torch.distributed as dist
    from reconfigisp_tpu_torch.parallel import mesh as meshlib
    backend = meshlib.init_process_group(
        no_tf32, init_method=f"file://{tmp_path / 'store'}", rank=0, world=1)
    try:
        yield backend
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("k", [1, 2])
def test_nccl_mesh_captured_step_equals_no_mesh(nccl, k):
    """One NCCL rank with make_mesh(1) passed explicitly, so that the
    step's all-reduces run inside its captured graph, at K = 1 and 2,
    against the trainer without a mesh on the same 4 steps: 15 launches of
    each kernel a step, counted through the replays, a replay's tally as
    test_launch_counts_under_replay has it, and the logs and state as
    test_captured_step_equals_eager_step holds them."""
    from reconfigisp_tpu_torch.parallel import mesh as meshlib
    assert nccl == "nccl"
    cuda = torch.device("cuda")
    pairs = _graph_pairs(4)
    ref = _graph_trainer(cuda)
    want = _captured(ref, pairs)
    trainer = _graph_trainer(cuda, k, mesh=meshlib.make_mesh(1))
    kb.launches = km.launches = kf.launches = 0
    got = _captured(trainer, pairs)
    torch.cuda.synchronize()
    assert _launches() == {name: 15 * 4 for name in _MODULES}
    assert trainer.graph is not None and trainer.graph.launches == _REPLAY
    _assert_logs_agree(got[k - 1::k], want[k - 1::k])
    _assert_trainers_agree(trainer, ref)

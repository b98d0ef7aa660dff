"""The bilateral, median and fast-NLM CUDA kernels against their plain
PyTorch forms, on the card, forward and backward, a few steps of step-2
training through them, the supernet and a second-order DARTS step through them,
the train and test CLIs on the card, the YOLOv3 evaluator's forward and
criterion gradient on the card against the CPU, and the kernels as custom
ops: opcheck, their gradients, fast NLM's and the bilateral's backward
kernels repeated and replayed bit for bit, and serving artifacts exported
on the card and on the
CPU; the search step captured as a CUDA graph against the eager step,
K-step dispatch, launch counts under replay, and a host read inside a
capture raising.

Needs an NVIDIA GPU and nvcc; every test skips without a card.  The file
imports no JAX, so on a machine without JAX it runs alone:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import reconfigisp_tpu_torch as rt
from reconfigisp_tpu_torch import convert
from reconfigisp_tpu_torch.ops import denoise
from reconfigisp_tpu_torch.ops.kernels import _build, _vjp
from reconfigisp_tpu_torch.ops.kernels import bilateral as kb
from reconfigisp_tpu_torch.ops.kernels import fastnlm as kf
from reconfigisp_tpu_torch.ops.kernels import median as km
from reconfigisp_tpu_torch.search import DartsTrainer, IspTrainer
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
_BACKWARD_KERNELS = ("bilateral", "fastnlm")   # a backward kernel on the card


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
    x and params is the plain form's autograd.  Median: bit for bit where
    the backward is direct (<= 640 rows), within 1e-5 where it goes by
    strips.  Fast NLM's and the bilateral's backward kernels recompute y
    and the clip's mask in the plain form's arithmetic but sum the gradient
    in their own order, and their params gradient is a sum over every pixel
    and offset that cancels: gx and gp within 1e-4 of their largest
    reference value, at every frame size."""
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
    if name in _BACKWARD_KERNELS:
        assert float((gx - wx).abs().max()) <= 1e-4 * float(wx.abs().max())
        assert float((gp - wp).abs().max()) <= 1e-4 * float(wp.abs().max())
        return
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


# ------------------------------------------------------------- entry points

_REPO = Path(__file__).resolve().parents[1]
_SLICE2 = "Bayer_01_Demosaic_03_sRGB_08_09_01_13_11"


def _cli(args, cwd):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(_REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                        if p])
    return subprocess.run([sys.executable, "-m", *args], cwd=str(cwd),
                          env=env, capture_output=True, text=True,
                          timeout=600)


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
    from reconfigisp_tpu_torch.utils import checkpoint
    bank = checkpoint.load_network(
        str(_REPO / "experiments" / "proxies" / "default.ckpt"))
    pipe = rt.Pipeline(_SLICE2, device=cuda)
    pipe.load_state(convert.state_from_bank(bank, pipe))
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
    head within 1e-4 of its largest magnitude (chip_smoke.YOLO_CARD_RTOL
    and its reason), the full 80-class graph at 128x128."""
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
    """The median's backward returns _vjp.vjp of the plain form on the
    saved inputs, as the autograd Function it replaces did: bit for bit,
    direct and by strips, launching the kernel once.  Fast NLM's and the
    bilateral's return their backward kernel's gradient, bit for bit,
    which is within 1e-4 of the largest value of _vjp.vjp's
    (test_op_gradient_on_cuda_is_the_plain_forms gives the reason)."""
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
    if name in _BACKWARD_KERNELS:
        kernel = mod.backward_kernel(x, p, g)[:2]
        torch.cuda.synchronize()
        for a, b, k in zip(got, want, kernel):
            assert torch.equal(a, k)
            assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
        return
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


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


_SLICE1 = "Bayer_01_Demosaic_03_sRGB_07_01_13_11"
_KERNELS_OF = {_SLICE1: ("bilateral",), _SLICE2: ("median", "fastnlm")}


def _bank_pipeline(arch, device):
    from reconfigisp_tpu_torch.utils import checkpoint
    bank = checkpoint.load_network(
        str(_REPO / "experiments" / "proxies" / "default.ckpt"))
    pipe = rt.Pipeline(arch, device=device)
    return pipe.load_state(convert.state_from_bank(bank, pipe))


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


# ------------------------------------------------------------- CUDA graphs

# SID_search's slots (3 of the first 9 sRGB ops: the three kernels) at its
# crop geometry; a MultiStepLR milestone at step 2 moves the lr within a run
_GRAPH_OPT = {"lr_G": 1e-2, "momentum_G": 0.9, "lr_meta": 1e-2, "beta1": 0.9,
              "beta2": 0.99, "pixel_criterion": "l2",
              "lr_scheme": "MultiStepLR", "lr_steps": [2], "lr_gamma": 0.5}


def _graph_trainer(device, k=1):
    return DartsTrainer(SuperNet(3, 0.2, srgb_count=9, device=device),
                        dict(_GRAPH_OPT, steps_per_dispatch=k))


def _graph_pairs(n):
    rng = np.random.default_rng(35)
    mk = lambda c: rng.uniform(0.05, 0.95, (4, 48, 48, c)).astype(np.float32)
    return [({"noisy": mk(1), "gt": mk(3)}, {"noisy": mk(1), "gt": mk(3)})
            for _ in range(n)]


def _assert_trainers_agree(got, want):
    """Alphas within 1e-5, theta within 1e-6 and the optimiser state within
    1e-3 of its largest value (chip_smoke.py's SEARCH_*_TOL and
    DISPATCH_STATE_RTOL, and their reasons); the same kernels on the same
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


def _eager(trainer, pairs):
    """The trainer's step function run eagerly as search_step schedules
    it -> the logs as floats."""
    logs = []
    for tb, vb in pairs:
        trainer.step_idx += 1
        batch = {k: trainer._tensor(v)
                 for k, v in trainer.step_batch(tb, vb).items()}
        trainer.variables, trainer.opt_state, out = trainer._step(
            trainer.variables, trainer.opt_state, batch,
            trainer.schedule(trainer.step_idx))
        logs.append({k: float(v) for k, v in out.items()})
    return logs


def test_captured_step_equals_eager_step(cuda):
    """3 steps as replays of the captured graph against the eager step
    from the same start, TF32 off: each step's losses within 1e-5
    relative, and the variables and state (_assert_trainers_agree)."""
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        pairs = _graph_pairs(3)
        eager, captured = _graph_trainer(cuda), _graph_trainer(cuda)
        want = _eager(eager, pairs)
        got = [captured.search_step(tb, vb) for tb, vb in pairs]
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert captured.graph is not None and eager.graph is None
    for a, b in zip(got, want):
        for k in ("loss", "val_loss"):
            assert abs(a[k] - b[k]) <= 1e-5 * abs(b[k]), (k, a, b)
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
    for a, b in ((logs3[2], logs1[2]), (logs3[5], logs1[5]),
                 (three.last_logs, one.last_logs)):
        for k in ("loss", "val_loss"):
            assert abs(a[k] - b[k]) <= 1e-5 * abs(b[k]), (k, a, b)
    _assert_trainers_agree(three, one)


def test_launch_counts_under_replay(cuda):
    """The capture's launches are a replay's (15 a kernel; fast NLM's
    backward kernel 15 applications of 4 launches, one group at the crops'
    4 x 48^2 x 3; the bilateral's 15 of 3), added to the kernels' counts on
    each replay; the warm-up step's are kept apart, so the counts hold from
    the first step on."""
    trainer = _graph_trainer(cuda)
    pairs = _graph_pairs(2)
    kb.launches = km.launches = kf.launches = kf.backward_launches = 0
    kb.backward_launches = 0
    trainer.search_step(*pairs[0])
    assert (kb.launches, km.launches, kf.launches) == (15, 15, 15)
    assert (kf.backward_launches, kb.backward_launches) == (15 * 4, 15 * 3)
    trainer.search_step(*pairs[1])
    assert (kb.launches, km.launches, kf.launches) == (30, 30, 30)
    assert (kf.backward_launches, kb.backward_launches) == (30 * 4, 30 * 3)
    want = {"bilateral": 15, "median": 15, "fastnlm": 15,
            "fastnlm.backward": 15 * 4, "bilateral.backward": 15 * 3}
    assert trainer.graph.launches == trainer.graph.warmup_launches == want


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

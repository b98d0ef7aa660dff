"""The search's K-step dispatch on the CPU: make_darts_multi_step against
sequential steps, DartsTrainer's buffer under resume and load_pretrained,
and the step's freedom from host reads and host copies, which a CUDA graph
capture of it needs.  Port only: the JAX package's K-step dispatch is held
against the JAX trainers in test_torch_darts.py and
test_torch_darts_ft.py."""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from reconfigisp_tpu_torch.ops import tone
from reconfigisp_tpu_torch.ops.kernels import _vjp
from reconfigisp_tpu_torch.search import DartsTrainer
from reconfigisp_tpu_torch.search.darts import (
    DartsConfig, init_darts_opt_state, make_darts_multi_step,
    make_darts_step)
from reconfigisp_tpu_torch.search.trainer import make_yolo_criterion
from reconfigisp_tpu_torch.supernet import SuperNet
from reconfigisp_tpu_torch.utils import losses
from reconfigisp_tpu_torch.utils.checkpoint import load_network
from reconfigisp_tpu_torch.yolo import loss as yloss
from reconfigisp_tpu_torch.yolo.cfg import yolov3_tiny_test_blocks
from reconfigisp_tpu_torch.yolo.net import init_yolo
from torch_one_thread import one_thread  # noqa: F401  (autouse)

BANK = "experiments/proxies/default.ckpt"
CFG = dict(lr_theta=1e-2, lr_alpha=1e-2, lr_meta=1e-2, momentum=0.9)
# first order: the trainers' buffer is what these tests hold, and the
# multi-step test holds both orders
TRAIN_OPT = {"lr_G": 1e-2, "momentum_G": 0.9, "lr_meta": 1e-2, "beta1": 0.9,
             "beta2": 0.99, "pixel_criterion": "l2", "darts_order": 1,
             "lr_scheme": "MultiStepLR", "lr_steps": [2], "lr_gamma": 0.5}


def _batch(seed, size=8, keys=("img", "gt", "val_img", "val_gt"), n=1):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.uniform(
        0.05, 0.95, (n, size, size, 1 if "img" in k or k == "noisy" else 3)
    ).astype(np.float32)) for k in keys}


def _forward(net, with_mids=False):
    """The DARTS forward; with_mids returns the 3-channel intermediates, as
    DartsFtTrainer's does."""
    def forward(theta, alphas, omega, img):
        y, aux = net({"theta": theta, "alphas": alphas, "omega": omega},
                     img, return_aux=True)
        if not with_mids:
            return y, aux["latency"]
        return y, aux["latency"], torch.stack(
            [m for m in aux["intermediates"] if m.shape[-1] == 3])
    return forward


def _equal(a, b):
    if isinstance(a, dict):
        return all(_equal(a[k], b[k]) for k in a)
    return torch.equal(a, b)


# ------------------------------------------------------ make_darts_multi_step

@pytest.mark.parametrize("order", [2, 1])
def test_multi_step_equals_sequential_steps(order):
    """4 stacked batches and a (4,) vector of lr scales against 4 calls of
    the step: variables, optimiser state and the last logs bit for bit, and
    every step's intermediates, flattened to (4 n_mids, ...) in step
    order."""
    net = SuperNet(1, 0.2, srgb_count=6, device="cpu")
    step = make_darts_step(_forward(net, with_mids=True),
                           losses.make_criterion("l2"),
                           DartsConfig(order=order, **CFG))
    v = net.init()
    o = init_darts_opt_state(v)
    batches = [_batch(70 + i) for i in range(4)]
    lrs = [1.0, 0.5, 0.5, 0.25]
    sv, so, mids = v, o, []
    for b, lr in zip(batches, lrs):
        sv, so, slogs = step(sv, so, b, lr)
        mids.append(slogs.pop("_mids"))
    stacked = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
    mv, mo, mlogs = make_darts_multi_step(step)(v, o, stacked,
                                                torch.tensor(lrs))
    assert _equal(mv["theta"], sv["theta"])
    assert _equal(mv["alphas"], sv["alphas"])
    assert _equal(mo, so)
    got_mids = mlogs.pop("_mids")
    assert _equal(mlogs, slogs)
    n_mids = mids[0].shape[0]
    assert n_mids == 2   # demosaic and step1
    assert tuple(got_mids.shape) == (4 * n_mids, 1, 8, 8, 3)
    assert torch.equal(got_mids, torch.cat(mids))


# ------------------------------------------------------------- the trainer

def _trainer(k):
    return DartsTrainer(SuperNet(1, 0.2, srgb_count=6, device="cpu"),
                        dict(TRAIN_OPT, steps_per_dispatch=k))


def _pairs(seed, n):
    keys = ("noisy", "gt")
    return [(_batch(seed + 2 * i, keys=keys), _batch(seed + 2 * i + 1,
                                                     keys=keys))
            for i in range(n)]


def test_load_pretrained_flushes_the_buffered_steps():
    """K = 4 with 2 steps buffered: load_pretrained runs them first, with
    the weights they were taken under, then installs; 2 more steps and a
    flush are a K = 1 trainer's 4 steps around the same install, bit for
    bit, and the install writes into omega's modules."""
    bank = load_network(BANK)
    pairs = _pairs(80, 4)
    runs = {}
    for k in (4, 1):
        t = _trainer(k)
        modules = dict(t.variables["omega"])
        for tb, vb in pairs[:2]:
            t.search_step(tb, vb)
        assert sorted(t.load_pretrained(bank)) == ["demosaicnet",
                                                   "path_bayer"]
        assert t._buf == [] and t.step_idx == 2
        assert all(t.variables["omega"][n] is m for n, m in modules.items())
        for tb, vb in pairs[2:]:
            t.search_step(tb, vb)
        t.flush()
        runs[k] = t
    assert runs[4].step_idx == runs[1].step_idx == 4
    assert runs[4].last_logs == runs[1].last_logs
    for key in ("theta", "alphas"):
        assert _equal(runs[4].variables[key], runs[1].variables[key])
    assert _equal(runs[4].opt_state, runs[1].opt_state)


def test_resume_drops_the_buffered_steps(tmp_path):
    """A state saved at step 2 resumed into a K = 4 trainer that holds 3
    buffered steps of another run: they are dropped, the state is written
    into the trainer's own tensors, and 2 more steps and a flush are those
    of a K = 1 trainer resumed from the same state."""
    saver = _trainer(1)
    for tb, vb in _pairs(90, 2):
        saver.search_step(tb, vb)
    saver.save(str(tmp_path / "models"), str(tmp_path / "state"), epoch=1)
    state = str(tmp_path / "state" / "2.state")
    more = _pairs(100, 2)

    resumed = _trainer(4)
    for tb, vb in _pairs(110, 3):
        resumed.search_step(tb, vb)
    tensors = [resumed.variables["alphas"]["step1"],
               resumed.opt_state["adam_m"]["step1"],
               resumed.variables["omega"]["path_bayer"]]
    assert resumed.resume(state) == 1
    assert resumed._buf == [] and resumed.step_idx == 2
    assert resumed.variables["alphas"]["step1"] is tensors[0]
    assert resumed.opt_state["adam_m"]["step1"] is tensors[1]
    assert resumed.variables["omega"]["path_bayer"] is tensors[2]
    assert torch.equal(tensors[0], saver.variables["alphas"]["step1"])

    single = _trainer(1)
    single.resume(state)
    for t in (resumed, single):
        for tb, vb in more:
            t.search_step(tb, vb)
    resumed.flush()
    assert resumed.step_idx == single.step_idx == 4
    assert resumed.last_logs == single.last_logs
    for key in ("theta", "alphas"):
        assert _equal(resumed.variables[key], single.variables[key])


# ------------------------------------------------ nothing read on the host

class _HostOps(TorchDispatchMode):
    """Raises at an op that reads a tensor on the host (.item(), int(), a
    data-dependent shape) or makes one from host data (torch.tensor, a list
    index, from_numpy): on the card the first syncs, the second copies from
    the host, and a CUDA graph capture takes neither."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if name.startswith(("aten._local_scalar_dense", "aten.lift_fresh",
                            "aten.nonzero", "aten.masked_select")):
            raise AssertionError(f"host op {name}")
        return func(*args, **(kwargs or {}))


def _yolo_case():
    detector = init_yolo(yolov3_tiny_test_blocks(80),
                         torch.Generator().manual_seed(0), device="cpu")
    labels = np.zeros((2, 4, 6), np.float32)
    labels[:, 0] = [1, 3, 0.5, 0.5, 0.3, 0.2]
    labels[0, 1] = [1, 5, 0.2, 0.3, 0.1, 0.1]
    batch = _batch(121, size=32, n=2)
    batch["gt"] = batch["val_gt"] = torch.from_numpy(labels)
    return make_yolo_criterion(detector, 32), batch


@pytest.mark.parametrize("case", ["windowed", "proxies", "yolo"])
def test_step_reads_and_copies_nothing_on_the_host(case):
    """The step's capture-safe run (_vjp.static_bounds, as the graph
    runner's warm-up and capture), after one warm-up step that fills the
    per-device constants: srgb 9 natively (the three windowed ops and the
    tone ops, their backward op included), srgb 15 through the proxies (the
    bank of SRCNN-Res proxies), and a detector's criterion."""
    criterion = losses.make_criterion("l2")
    batch = _batch(120)
    net = SuperNet(1, 0.2, srgb_count=9, device="cpu")
    if case == "proxies":
        net = SuperNet(1, 0.2, use_proxies=True, srgb_count=15, device="cpu")
    elif case == "yolo":
        net = SuperNet(1, 0.2, srgb_count=6, device="cpu")
        criterion, batch = _yolo_case()
    step = make_darts_step(_forward(net), criterion, DartsConfig(order=1))
    v = net.init()
    o = init_darts_opt_state(v)
    lr = torch.ones(())
    with _vjp.static_bounds():
        step(v, o, batch, lr)
        with _HostOps():
            step(v, o, batch, lr)


def test_device_constants_made_in_inference_mode_serve_autograd():
    """The per-device constants the step reads (the tone ops' luminance
    weights, the detector's anchors) made first under inference mode, as a
    served pipeline makes them, are normal tensors that autograd saves."""
    tone._LUM.clear()
    yloss._ANCHORS.clear()
    x = torch.rand((1, 8, 8, 3))
    p = torch.full((1, 2), 0.5)
    with torch.inference_mode():
        tone.tone_reinhard(x, p)
        yloss._anchors_per_cell([(10, 13), (16, 30)], 8.0, "cpu")
    xs = x.clone().requires_grad_()
    anchors = yloss._anchors_per_cell([(10, 13), (16, 30)], 8.0, "cpu")
    torch.autograd.grad((tone.tone_reinhard(xs, p).sum()
                         + (xs.sum() * anchors).sum()), xs)

"""The port's YOLO modules against the JAX package's, on the CPU: the graph
(block lists, parse_cfg, forwards, darknet files), the loss (targets, head
losses, the frozen criterion's input gradient, decode), NMS and mAP, and the
detection data (synthetic samples and batches, the Bayer-aware resize, the
OnePlus PNG + labelme dataset).

Inputs come from numpy seeds; both packages get the same weights, carried by
convert.yolo_weights_from_jax or by one darknet file.  JAX convs run at
"highest" precision (this JAX build defaults them to bf16 on the CPU).

Tolerances:
  * the tiny_test graph, per head: 1e-5 (f32 convs of 16-64 channels,
    summed in another order);
  * the full YOLOv3 from a JAX-written darknet file at 32x32: heads within
    1e-5 (75 f32 convs; the heads' values are of order 0.05 at the init);
  * darknet files: byte-equal;
  * build_targets: exact, except tw and th, which go through log: XLA's
    and PyTorch's f32 log round apart by one ulp on about 18 % of inputs, so
    those two are held to 1 ulp (rtol 2^-23), their cells exactly;
  * yolo_head_loss, yolo_loss: 1e-5 relative (sigmoid, exp and log1p of
    both libraries, summed in another order);
  * the criterion's input gradient: 1e-4 of its largest value;
  * decode_head: 1e-6 relative (the exp again);
  * NMS, batch statistics, AP: equal (the same numpy on the same inputs);
  * data: bit for bit.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reconfigisp_tpu.data import datasets as jdatasets
from reconfigisp_tpu.data import sampler as jsampler
from reconfigisp_tpu.search.trainer import make_yolo_criterion as jcriterion
from reconfigisp_tpu.utils import imaging as jimaging
from reconfigisp_tpu.yolo import cfg as jcfg
from reconfigisp_tpu.yolo import loss as jloss
from reconfigisp_tpu.yolo import metrics as jmetrics
from reconfigisp_tpu.yolo import net as jnet

from reconfigisp_tpu_torch import convert
from reconfigisp_tpu_torch.data import datasets, sampler
from reconfigisp_tpu_torch.search.trainer import make_yolo_criterion
from reconfigisp_tpu_torch.utils import imaging
from reconfigisp_tpu_torch.yolo import cfg, loss, metrics, net as ynet
from torch_one_thread import one_thread  # noqa: F401  (autouse)

HEAD_TOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
DECODE_RTOL = 1e-6
ULP = 2.0 ** -23

CFG_TEXT = """
[net]
width=416

[convolutional]
batch_normalize=1
filters=16
size=3
stride=1
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=32
size=3
stride=2
pad=1
activation=leaky

[shortcut]
from=-3
activation=linear

[route]
layers = -1, 0

[upsample]
stride=2

[convolutional]
batch_normalize=0
filters=18
size=1
stride=1
pad=1
activation=linear

[yolo]
mask = 0,1,2
anchors = 10,13, 16,30, 33,23
classes=1
num=3
"""


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _highest(fn, *args):
    with jax.default_matmul_precision("highest"):
        return fn(*args)


@pytest.fixture(scope="module")
def tiny():
    """tiny_test with 2 classes, the JAX init and the port's copy of it."""
    blocks = jcfg.yolov3_tiny_test_blocks(num_classes=2)
    jw = jnet.init_yolo(jax.random.PRNGKey(3), blocks)
    net = convert.yolo_weights_from_jax(_np(jw), ynet.YoloNet(blocks))
    fwd = jax.jit(lambda w, x: [h[0] for h in jnet.apply_yolo(w, blocks, x)])
    return blocks, jw, net, fwd


@pytest.fixture(scope="module")
def yolov3_file(tmp_path_factory):
    """The full 80-class YOLOv3: JAX's init written by JAX's
    save_darknet_weights."""
    blocks = jcfg.yolov3_blocks(80)
    jw = jnet.init_yolo(jax.random.PRNGKey(5), blocks)
    path = str(tmp_path_factory.mktemp("yolov3") / "yolov3.weights")
    jnet.save_darknet_weights(blocks, jw, path)
    return blocks, jw, path


# ------------------------------------------------------------------ graph

@pytest.mark.parametrize("kind,n_cls,channels", [
    ("yolov3", 80, None), ("yolov3", 1, None), ("tiny_test", 1, None),
    ("tiny_test", 3, 8)])
def test_block_lists_equal_jax(kind, n_cls, channels):
    if kind == "yolov3":
        assert cfg.yolov3_blocks(n_cls) == jcfg.yolov3_blocks(n_cls)
    else:
        kw = {} if channels is None else {"channels": channels}
        assert cfg.yolov3_tiny_test_blocks(n_cls, **kw) == \
            jcfg.yolov3_tiny_test_blocks(n_cls, **kw)
    assert cfg.YOLOV3_ANCHORS == jcfg.YOLOV3_ANCHORS


def test_parse_cfg_equals_jax(tmp_path):
    path = tmp_path / "t.cfg"
    path.write_text(CFG_TEXT)
    got, want = cfg.parse_cfg(str(path)), jcfg.parse_cfg(str(path))
    assert got == want
    assert [b["type"] for b in got] == [
        "convolutional", "convolutional", "shortcut", "route", "upsample",
        "convolutional", "yolo"]


@pytest.mark.parametrize("shape", [(2, 32, 32, 3), (1, 32, 48, 3)])
def test_tiny_forward_matches_apply_yolo(tiny, shape):
    """tiny_test's two heads, within HEAD_TOL each; the head layout (anchor
    major, field minor) is where a wrong reshape would part them."""
    blocks, jw, net, fwd = tiny
    x = np.random.default_rng(1).uniform(0, 1, shape).astype(np.float32)
    want = _highest(fwd, jw, jnp.asarray(x))
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert len(got) == len(want) == 2
    for (head, anchors, c), w, blk in zip(
            got, want, [b for b in blocks if b["type"] == "yolo"]):
        assert head.shape == w.shape
        assert anchors == [blk["anchors"][m] for m in blk["mask"]] and c == 2
        np.testing.assert_allclose(head.numpy(), np.asarray(w), rtol=0,
                                   atol=HEAD_TOL)


def test_full_yolov3_forward_from_jax_darknet_file(yolov3_file):
    """The full graph at 32x32, batch 1, loaded from the file JAX wrote:
    the 75 convs load in the graph's order or the heads part."""
    blocks, jw, path = yolov3_file
    net = ynet.load_darknet_weights(blocks, path)
    x = np.random.default_rng(2).uniform(0, 1, (1, 32, 32, 3)).astype(
        np.float32)
    fwd = jax.jit(lambda w, x: [h[0] for h in jnet.apply_yolo(w, blocks, x)])
    want = _highest(fwd, jw, jnp.asarray(x))
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert [tuple(h.shape) for h, _, _ in got] == [
        (1, 3, 1, 1, 85), (1, 3, 2, 2, 85), (1, 3, 4, 4, 85)]
    for (head, _, _), w in zip(got, want):
        assert float(np.abs(np.asarray(w)).max()) > 1e-3
        np.testing.assert_allclose(head.numpy(), np.asarray(w), rtol=0,
                                   atol=HEAD_TOL)


@pytest.mark.parametrize("which", ["tiny_test", "yolov3"])
def test_darknet_files_byte_equal(tiny, yolov3_file, tmp_path, which):
    """For the same weights, the port's darknet file is the JAX package's,
    byte for byte: tiny_test carried over by convert, the full YOLOv3 read
    back from JAX's file."""
    if which == "tiny_test":
        blocks, jw, net, _ = tiny
        want = str(tmp_path / "jax.weights")
        jnet.save_darknet_weights(blocks, jw, want)
    else:
        blocks, _, want = yolov3_file
        net = ynet.load_darknet_weights(blocks, want)
    got = str(tmp_path / "port.weights")
    ynet.save_darknet_weights(net, got)
    with open(got, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()


def test_load_checks_the_whole_file(tiny, tmp_path):
    blocks, _, net, _ = tiny
    path = tmp_path / "w.weights"
    ynet.save_darknet_weights(net, str(path))
    data = path.read_bytes()
    (tmp_path / "long").write_bytes(data + b"\0" * 4)
    (tmp_path / "short").write_bytes(data[:-4])
    for name in ("long", "short"):
        with pytest.raises(ValueError, match="weight file mismatch"):
            ynet.load_darknet_weights(blocks, str(tmp_path / name))
    back = ynet.load_darknet_weights(blocks, str(path))
    for a, b in zip(back.parameters(), net.parameters()):
        assert torch.equal(a, b)


def test_convert_round_trip(tiny):
    blocks, jw, net, _ = tiny
    got, want = convert.yolo_weights_to_jax(net), _np(jw)
    assert len(got) == len(want) == len(blocks)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert sorted(g) == sorted(w)
        for k in w:
            if k == "bn":
                for name in w[k]:
                    np.testing.assert_array_equal(g[k][name], w[k][name])
            else:
                np.testing.assert_array_equal(g[k], w[k])


def test_init_has_jax_distributions():
    """init_yolo draws U(-b, b), b = sqrt(1 / (k^2 Cin)), and the identity
    batch norm, as _conv_init does (the draws themselves are torch's)."""
    blocks = cfg.yolov3_tiny_test_blocks(1)
    net = ynet.init_yolo(blocks, torch.Generator().manual_seed(0))
    net.requires_grad_(False)
    for conv in net.conv_blocks():
        cout, cin, k, _ = conv.weight.shape
        bound = (1.0 / (k * k * cin)) ** 0.5
        assert float(conv.weight.abs().max()) <= bound
        assert float(conv.weight.abs().max()) > 0.8 * bound
        if conv.bn:
            assert torch.equal(conv.gamma, torch.ones(cout))
            assert torch.equal(conv.var, torch.ones(cout))
            assert not conv.beta.any() and not conv.mean.any()
        else:
            assert float(conv.bias.abs().max()) <= bound


# ------------------------------------------------------------------- loss

def _labels(seed, n=3, b=8, n_cls=1):
    """Random labels with invalid rows, boxes at the image edge (cx, cy of
    exactly 0 and 1), several boxes on one cell and anchor, and class ids
    up to n_cls."""
    rng = np.random.default_rng(seed)
    lab = np.zeros((n, b, 6), np.float32)
    lab[..., 0] = rng.uniform(0, 1, (n, b)) > 0.3
    lab[..., 1] = rng.integers(0, n_cls, (n, b))
    lab[..., 2:4] = rng.uniform(0, 1, (n, b, 2))
    lab[..., 4:6] = rng.uniform(0.02, 0.7, (n, b, 2))
    # three valid boxes of image 0 on one cell and anchor: the last wins
    lab[0, :3] = [1, 0, 0.55, 0.55, 0.25, 0.25]
    lab[0, 1, 2:4] = [0.52, 0.58]
    lab[0, 2, 2:4] = [0.53, 0.51]
    lab[0, 3] = [0, 0, 0.54, 0.54, 0.25, 0.25]   # invalid, on the same cell
    lab[1, 0, 2:4] = [1.0, 0.0]                  # corners
    lab[1, 1, 2:4] = [0.0, 1.0]
    lab[-1, 0] = [1, n_cls - 1, 0.3, 0.3, 0.9, 0.9]   # anchor IoU ties
    return lab


TARGET_CASES = {
    "square_1cls": (0, 8, 8, 1, [[1.0, 1.0], [2.0, 2.0], [4.0, 4.0]]),
    "wide_3cls": (1, 4, 6, 3, [[0.5, 1.5], [2.0, 2.0], [3.0, 1.0]]),
    "coarse_2cls": (2, 2, 2, 2, [[0.4, 0.4], [0.6, 0.6], [1.0, 1.0]]),
}


@pytest.mark.parametrize("case", sorted(TARGET_CASES))
def test_build_targets_equals_jax(case):
    seed, gh, gw, n_cls, anchors = TARGET_CASES[case]
    lab = _labels(seed, n_cls=n_cls)
    anchors = np.asarray(anchors, np.float32)
    want = jloss.build_targets(jnp.asarray(lab), jnp.asarray(anchors), gh, gw,
                               n_cls)
    got = loss.build_targets(torch.from_numpy(lab), torch.from_numpy(anchors),
                             gh, gw, n_cls)
    assert sorted(got) == sorted(want)
    for k in want:
        w, g = np.asarray(want[k]), got[k].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if k in ("tw", "th"):
            np.testing.assert_array_equal(g != 0, w != 0, err_msg=k)
            np.testing.assert_allclose(g, w, rtol=ULP, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)
    if case == "square_1cls":
        # the three boxes on one cell: row 2's offsets stay
        assert float(got["tx"][0, 1, 4, 4]) == pytest.approx(
            0.53 * 8 - 4, abs=1e-6)
        assert float(got["ty"][0, 1, 4, 4]) == pytest.approx(
            0.51 * 8 - 4, abs=1e-6)


def test_last_writes_keep_one_row_per_cell():
    """The rows build_targets writes: the last valid row of each image on
    each cell, so the card's scatter sees unique indices.  (On the CPU a
    scatter keeps the last of repeated indices anyway, so the targets alone
    could not tell.)"""
    cell = torch.tensor([[5, 5, 7, 5, 7, 9], [5, 5, 3, 3, 3, 1]])
    valid = torch.tensor([[1, 1, 1, 0, 1, 1], [0, 1, 1, 1, 0, 1]],
                         dtype=torch.bool)
    got = loss.last_writes(cell, valid)
    want = torch.tensor([[0, 1, 0, 0, 1, 1], [0, 1, 0, 1, 0, 1]],
                        dtype=torch.bool)
    assert torch.equal(got, want)
    lab = torch.from_numpy(_labels(0))
    valid = lab[..., 0] > 0.5
    gx = (lab[..., 2] * 8).to(torch.int32).clamp(0, 7).to(torch.int64)
    gy = (lab[..., 3] * 8).to(torch.int32).clamp(0, 7).to(torch.int64)
    kept = loss.last_writes(gy * 8 + gx, valid)
    assert int(kept.sum()) < int(valid.sum())
    for i in range(lab.shape[0]):
        cells = (gy * 8 + gx)[i][kept[i]]
        assert len(set(cells.tolist())) == len(cells)


@pytest.mark.parametrize("targets", ["boxes", "none"])
def test_head_and_total_loss_match_jax(tiny, targets):
    """Each head's loss (obj_scale 1, noobj_scale 100 and 5:2) and the sum,
    with boxes and with none (the objectness-only guard)."""
    blocks, jw, net, fwd = tiny
    x = np.random.default_rng(4).uniform(0, 1, (3, 32, 32, 3)).astype(
        np.float32)
    lab = _labels(5, n_cls=2) if targets == "boxes" else \
        np.zeros((3, 8, 6), np.float32)
    with torch.no_grad():
        heads = net(torch.from_numpy(x))
    jl, tl = jnp.asarray(lab), torch.from_numpy(lab)
    for kw in ({}, {"obj_scale": 5.0, "noobj_scale": 2.0}):
        for h, a, _ in heads:
            # the same raw head into both losses isolates the loss
            head_loss = jax.jit(lambda h_, l_: jloss.yolo_head_loss(
                h_, a, l_, 32, **kw))
            want = float(head_loss(jnp.asarray(h.numpy()), jl))
            got = float(loss.yolo_head_loss(h, a, tl, 32, **kw))
            assert got == pytest.approx(want, rel=LOSS_RTOL)
        total = jax.jit(lambda w_, x_, l_: jloss.yolo_loss(
            jnet.apply_yolo(w_, blocks, x_), l_, 32, **kw))
        want = float(_highest(total, jw, jnp.asarray(x), jl))
        got = float(loss.yolo_loss(heads, tl, 32, **kw))
        assert np.isfinite(got) and got > 0
        assert got == pytest.approx(want, rel=LOSS_RTOL)


def test_criterion_input_gradient_matches_jax(tiny):
    """The frozen criterion's loss and its gradient with respect to the
    BGR image (the ISP output), against jax.grad of make_yolo_criterion;
    no gradient reaches the detector's weights."""
    blocks, jw, net, _ = tiny
    x = np.random.default_rng(6).uniform(0, 1, (2, 32, 32, 3)).astype(
        np.float32)
    lab = _labels(7, n=2, n_cls=2)
    jcrit = jcriterion(blocks, jw, 32)
    with jax.default_matmul_precision("highest"):
        want_loss, want = jax.jit(jax.value_and_grad(
            lambda im, l_: jcrit(im, l_)))(jnp.asarray(x), jnp.asarray(lab))
    crit = make_yolo_criterion(net, 32)
    xt = torch.from_numpy(x).requires_grad_()
    got_loss = crit(xt, torch.from_numpy(lab), latency=torch.tensor(3.0))
    (got,) = torch.autograd.grad(got_loss, xt)
    assert float(got_loss.detach()) == pytest.approx(float(want_loss),
                                                     rel=LOSS_RTOL)
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=GRAD_TOL * scale)
    assert not any(p.requires_grad for p in net.parameters())


def test_decode_head_matches_jax():
    rng = np.random.default_rng(8)
    head = rng.normal(0, 1.5, (2, 3, 4, 6, 7)).astype(np.float32)
    anchors = [(10, 13), (16, 30), (33, 23)]
    want = jloss.decode_head(jnp.asarray(head), anchors, 24)
    got = loss.decode_head(torch.from_numpy(head), anchors, 24)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=DECODE_RTOL, atol=0)


# ---------------------------------------------------------------- metrics

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nms_statistics_and_ap_equal_jax(seed):
    """Random candidate boxes of 3 classes on 4 images, clustered so NMS
    merges; then the batch statistics against random GT and AP per class."""
    rng = np.random.default_rng(seed)
    dets_p, dets_j, gts = [], [], []
    tcls = []
    for _ in range(4):
        centres = rng.uniform(10, 90, (6, 2))
        boxes = np.concatenate([
            np.repeat(centres, 5, 0) + rng.normal(0, 2, (30, 2)),
            rng.uniform(4, 20, (30, 2))], 1).astype(np.float32)
        conf = rng.uniform(0, 1, 30).astype(np.float32)
        cls = rng.uniform(0, 1, (30, 3)).astype(np.float32)
        for dets, m in ((dets_p, metrics), (dets_j, jmetrics)):
            dets.append(m.non_max_suppression(boxes, conf, cls,
                                              conf_thres=0.3, max_dets=20))
        k = int(rng.integers(0, 5))
        xy = rng.uniform(0, 80, (k, 2))
        gt = np.concatenate([rng.integers(0, 3, (k, 1)), xy,
                             xy + rng.uniform(4, 20, (k, 2))], 1)
        gts.append(gt.astype(np.float32))
        tcls.extend(gt[:, 0].tolist())
    for a, b in zip(dets_p, dets_j):
        np.testing.assert_array_equal(a, b)
    stats = [metrics.get_batch_statistics(dets_p, gts, iou_threshold=t)
             for t in (0.5, 0.1)]
    want = [jmetrics.get_batch_statistics(dets_j, gts, iou_threshold=t)
            for t in (0.5, 0.1)]
    for s, w in zip(stats, want):
        assert len(s) == len(w)
        for a, b in zip(s, w):
            for u, v in zip(a, b):
                np.testing.assert_array_equal(u, v)
        cat = [np.concatenate([x[i] for x in s]) for i in range(3)]
        got = metrics.ap_per_class(*cat, tcls)
        exp = jmetrics.ap_per_class(*cat, tcls)
        assert sorted(got) == sorted(exp)
        for key in exp:
            np.testing.assert_array_equal(got[key], exp[key])
    assert metrics.compute_ap(np.array([0.5, 1.0]), np.array([1.0, 0.5])) \
        == jmetrics.compute_ap(np.array([0.5, 1.0]), np.array([1.0, 0.5]))


# ------------------------------------------------------------------- data

def _assert_samples_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in b:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("size,seed", [(32, 0), (64, 3), (48, 11)])
def test_synthetic_detection_bit_identical(size, seed):
    """Samples, the factory's choice, and the loader's stacked batches."""
    a = datasets.SyntheticDetectionDataset(n=6, size=size, seed=seed)
    b = jdatasets.SyntheticDetectionDataset(n=6, size=size, seed=seed)
    for idx in (0, 5, 2):
        _assert_samples_equal(a[idx], b[idx])
    assert a[1]["label"].shape == (8, 6)
    opt = {"mode": "synthetic_yolo", "n": 5, "data_size": 16,
           "frame_size": size, "seed": seed}
    fa, fb = datasets.create_dataset(opt), jdatasets.create_dataset(opt)
    assert type(fa).__name__ == type(fb).__name__ == \
        "SyntheticDetectionDataset"
    assert fa.size == fb.size == size
    la, lb = (iter(m.create_loader(ds, 2, shuffle_seed=seed))
              for m, ds in ((sampler, a), (jsampler, b)))
    for _ in range(4):
        _assert_samples_equal(next(la), next(lb))


@pytest.mark.parametrize("shape,target", [((64, 96), 48), ((96, 64), 32),
                                          ((40, 40), 40), ((60, 100, 1), 64)])
def test_bayer_aware_resize_equal(shape, target):
    m = np.random.default_rng(9).uniform(0, 1, shape).astype(np.float32)
    got, ext = imaging.bayer_aware_resize(m, target, return_extent=True)
    want, wext = jimaging.bayer_aware_resize(m, target, return_extent=True)
    assert ext == wext and got.shape == (target, target, 1)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(imaging.bayer_aware_resize(m, target),
                                  jimaging.bayer_aware_resize(m, target))


def _write_oneplus(root):
    """Two 64x96 uint16 10-bit mosaics with labelme JSONs: boxes of the
    three classes, one of another label, one across the frame's edge."""
    import cv2
    root.mkdir()
    rng = np.random.default_rng(12)
    shapes = [
        [("person", [[10, 8], [30, 40]]), ("car", [[50, 20], [90, 50]]),
         ("dog", [[0, 0], [5, 5]])],
        [("bus", [[60, 30], [95, 63]]), ("person", [[2, 2], [20, 30]]),
         ("car", [[40, 10], [44, 12]])],
    ]
    for i, boxes in enumerate(shapes):
        img = rng.integers(0, 1024, (64, 96), dtype=np.uint16)
        assert cv2.imwrite(str(root / f"f{i}.png"), img)
        (root / f"f{i}.json").write_text(json.dumps({"shapes": [
            {"label": lab, "points": pts} for lab, pts in boxes]}))
    return str(root)


@pytest.mark.parametrize("mode", ["train", "eval_tiles", "eval_whole"])
def test_oneplus_dataset_equal(tmp_path, mode):
    """Train crops (re-drawn up to max_crop, fresh at each access), eval
    tiles, and a whole-frame eval, from the factory of each package."""
    root = _write_oneplus(tmp_path / "oneplus")
    opt = {"mode": "OnePlus_Rggb2Obj", "dataroot": root, "desired_size": 64,
           "max_crop": 3, "max_boxes": 4, "seed": 2,
           "data_size": None if mode == "eval_whole" else 32,
           "is_train": mode == "train"}
    a, b = datasets.create_dataset(opt), jdatasets.create_dataset(opt)
    assert type(a).__name__ == type(b).__name__ == "OnePlusDetectionDataset"
    assert len(a) == len(b)
    assert a._eval_tiles == b._eval_tiles
    for idx in [0, 1, 0, len(a) - 1, 1]:
        _assert_samples_equal(a[idx], b[idx])
    if mode == "train":
        assert a[0]["noisy"].shape == (32, 32, 1)


def test_yolo_modules_import_no_jax():
    """The port's yolo modules, and the trainer and CLI that use them, pull
    in neither JAX nor the JAX package."""
    from test_torch_cli import REPO, _run
    code = ("import sys, reconfigisp_tpu_torch.yolo.cfg, "
            "reconfigisp_tpu_torch.yolo.net, reconfigisp_tpu_torch.yolo.loss, "
            "reconfigisp_tpu_torch.yolo.metrics, "
            "reconfigisp_tpu_torch.yolo.train, reconfigisp_tpu_torch.convert, "
            "reconfigisp_tpu_torch.search.trainer, "
            "reconfigisp_tpu_torch.test; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'reconfigisp_tpu' "
            "or m.startswith('reconfigisp_tpu.')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    r = _run(["-c", code], REPO, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr

"""Detector pretraining and mAP evaluation.

Counterpart of reconfigisp_tpu/yolo/train.py.  The reference uses YOLOv3
strictly as a frozen pretrained evaluator (reference
codes/models/darts_yolo_model.py:37-40); `pretrain_yolo` trains a (tiny)
detector on rendered images until it detects, for workloads with no
pretrained checkpoint, and `evaluate_map` scores one.  `detections`,
`label_boxes` and `score` are the decode, NMS and AP steps that evaluate_map
and the test CLI share.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from reconfigisp_tpu_torch.pipeline import resolve_device
from reconfigisp_tpu_torch.yolo import metrics as ymetrics
from reconfigisp_tpu_torch.yolo.loss import decode_head, yolo_loss
from reconfigisp_tpu_torch.yolo.net import YoloNet, init_yolo


def pretrain_yolo(blocks: List[dict], images_bgr, labels, img_size: int, *,
                  steps: int = 600, lr: float = 3e-3, batch: int = 4,
                  seed: int = 0, net: Optional[YoloNet] = None,
                  log_every: int = 0, obj_scale: float = 5.0,
                  noobj_scale: float = 2.0, device=None) -> YoloNet:
    """Adam-train a YOLO graph on (images, labels) until it detects.

    images_bgr (N, S, S, 3) in [0, 1]; labels (N, max_boxes, 6)
    [valid, cls, cx, cy, w, h].  Trains `net` where it lies, else a fresh
    init_yolo from seed `seed` on `device` (cuda unless "cpu" is named), and
    returns it.  Each step takes min(batch, N) images at indices drawn from
    numpy's default_rng(seed), as the JAX package draws them; Adam is the
    JAX package's (utils/optim.adam_update): beta2 0.99, eps 1e-8 outside
    the square root, every weight trained, batch-norm statistics included.

    The loss balance differs from yolo_head_loss's inference-parity default
    (reference noobj_scale=100): a 100:1 negative:positive ratio needs tens
    of thousands of iterations to lift objectness; 5:2 reaches mAP 0.5+ on
    the synthetic-box workload in ~600 steps."""
    if net is None:
        net = init_yolo(blocks, torch.Generator().manual_seed(seed),
                        device=resolve_device(device))
    dev = next(net.parameters()).device
    net.requires_grad_(True)
    images = torch.as_tensor(np.asarray(images_bgr, np.float32), device=dev)
    labels = torch.as_tensor(np.asarray(labels, np.float32), device=dev)
    n = images.shape[0]
    params = list(net.parameters())
    optimizer = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.99), eps=1e-8)
    rng = np.random.default_rng(seed)
    for i in range(steps):
        idx = torch.as_tensor(rng.integers(0, n, size=min(batch, n)),
                              device=dev)
        heads = net(images[idx].flip(-1))
        loss = yolo_loss(heads, labels[idx], img_size, obj_scale=obj_scale,
                         noobj_scale=noobj_scale)
        grads = torch.autograd.grad(loss, params)
        for p, g in zip(params, grads):
            p.grad = g
        optimizer.step()
        if log_every and (i + 1) % log_every == 0:
            print(f"[yolo] step {i + 1}/{steps} loss {float(loss):.3f}",
                  flush=True)
    return net


def detections(heads: list, img_size: int, conf_thres: float) -> list:
    """YoloNet's heads on a batch -> per image, NMS's (D, 7) detections
    [x1, y1, x2, y2, conf, cls_conf, cls] of the boxes decoded at
    `img_size` (the frame's height)."""
    decoded = []
    for head, anchors, _ in heads:
        b, cf, cl = decode_head(head, anchors, img_size)
        decoded.append((b.float().cpu().numpy(), cf.float().cpu().numpy(),
                        cl.float().cpu().numpy()))
    out = []
    for i in range(decoded[0][0].shape[0]):
        boxes = np.concatenate([d[0][i].reshape(-1, 4) for d in decoded])
        confs = np.concatenate([d[1][i].reshape(-1) for d in decoded])
        clss = np.concatenate([d[2][i].reshape(-1, d[2].shape[-1])
                               for d in decoded])
        out.append(ymetrics.non_max_suppression(boxes, confs, clss,
                                                conf_thres=conf_thres))
    return out


def label_boxes(label: np.ndarray, frame_h: int, frame_w: int):
    """One image's (B, 6) labels -> ((K, 5) [cls, x1, y1, x2, y2] boxes in
    pixels of a frame_h x frame_w frame, the K valid rows' classes)."""
    label = np.asarray(label)
    valid = label[label[:, 0] > 0.5]
    gtb = np.zeros((len(valid), 5), np.float32)
    gtb[:, 0] = valid[:, 1]
    gtb[:, 1] = (valid[:, 2] - valid[:, 4] / 2) * frame_w
    gtb[:, 2] = (valid[:, 3] - valid[:, 5] / 2) * frame_h
    gtb[:, 3] = (valid[:, 2] + valid[:, 4] / 2) * frame_w
    gtb[:, 4] = (valid[:, 3] + valid[:, 5] / 2) * frame_h
    return gtb, valid[:, 1].tolist()


def score(all_dets: list, all_gts: list, all_tcls: list) -> Optional[dict]:
    """precision/recall/AP/F1 per class and mAP over the frames, or None
    when no frame has a detection."""
    stats = ymetrics.get_batch_statistics(all_dets, all_gts)
    if not stats:
        return None
    return ymetrics.ap_per_class(
        np.concatenate([s[0] for s in stats]),
        np.concatenate([s[1] for s in stats]),
        np.concatenate([s[2] for s in stats]), all_tcls)


@torch.no_grad()
def evaluate_map(net: YoloNet, images_bgr, labels, img_size: int, *,
                 conf_thres: float = 0.5) -> dict:
    """mAP of the detector over (images, labels), through the same decode,
    NMS and AP as the test CLI (reference util_yolo.py:81-200)."""
    dev = next(net.parameters()).device
    images = torch.as_tensor(np.asarray(images_bgr, np.float32), device=dev)
    dets = detections(net(images.flip(-1)), img_size, conf_thres)
    all_gts, all_tcls = [], []
    for lab in np.asarray(labels):
        gtb, tcls = label_boxes(lab, img_size, img_size)
        all_gts.append(gtb)
        all_tcls.extend(tcls)
    out = score(dets, all_gts, all_tcls)
    if out is None:
        return {"mAP": 0.0, "n_det": 0}
    out["n_det"] = int(sum(len(d) for d in dets))
    return out

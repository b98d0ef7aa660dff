"""Detection evaluation: NMS, precision/recall/AP/F1 (host-side numpy).

The port's own copy of reconfigisp_tpu/yolo/metrics.py (reference
codes/models/modules/util_yolo.py:81-284: ap_per_class, compute_ap,
get_batch_statistics, non_max_suppression, bbox_iou), the same numpy
statement for statement.  Evaluation is host-side by nature (variable-length
detections); the device path ends at the decoded prediction tensors.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def xywh2xyxy(b: np.ndarray) -> np.ndarray:
    out = b.copy()
    out[..., 0] = b[..., 0] - b[..., 2] / 2
    out[..., 1] = b[..., 1] - b[..., 3] / 2
    out[..., 2] = b[..., 0] + b[..., 2] / 2
    out[..., 3] = b[..., 1] + b[..., 3] / 2
    return out


def box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU matrix between (M,4) and (K,4) xyxy boxes
    (reference util_yolo.py:212-243)."""
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(br - tl, 0, None), axis=2)
    area_a = np.prod(a[:, 2:] - a[:, :2], axis=1)
    area_b = np.prod(b[:, 2:] - b[:, :2], axis=1)
    return inter / np.clip(area_a[:, None] + area_b[None, :] - inter,
                           1e-9, None)


def non_max_suppression(boxes_xywh: np.ndarray, conf: np.ndarray,
                        cls_probs: np.ndarray, conf_thres: float = 0.5,
                        nms_thres: float = 0.4,
                        max_dets: int = 500) -> np.ndarray:
    """One image -> (D, 7) [x1,y1,x2,y2,conf,cls_conf,cls]
    (reference util_yolo.py:245-284: greedy, score-weighted box merge).

    conf_thres 0.5 matches the reference's *rendering* path; mAP
    evaluation ranks ALL detections, so eval configs pass a low
    threshold (the upstream the reference vendored util_yolo from,
    eriklindernoren/PyTorch-YOLOv3, evaluates mAP at conf 0.001 and
    renders at 0.5).  max_dets caps the candidates entering the O(D^2)
    greedy merge at the top-confidence max_dets."""
    score = conf
    keep = score >= conf_thres
    if not keep.any():
        return np.zeros((0, 7), np.float32)
    if int(keep.sum()) > max_dets:
        kth = np.sort(score[keep])[-max_dets]
        keep = keep & (score >= kth)
    boxes = xywh2xyxy(boxes_xywh[keep])
    conf = conf[keep]
    cls_conf = cls_probs[keep].max(axis=1)
    cls_id = cls_probs[keep].argmax(axis=1).astype(np.float32)
    order = np.argsort(-conf)
    boxes, conf, cls_conf, cls_id = (boxes[order], conf[order],
                                     cls_conf[order], cls_id[order])
    out = []
    while len(boxes):
        ious = box_iou(boxes[:1], boxes)[0]
        match = (ious > nms_thres) & (cls_id == cls_id[0])
        # conf-weighted merge of suppressed boxes (util_yolo.py:278-281)
        w = conf[match]
        merged = (boxes[match] * w[:, None]).sum(0) / w.sum()
        out.append(np.concatenate(
            [merged, [conf[0], cls_conf[0], cls_id[0]]]))
        boxes, conf, cls_conf, cls_id = (boxes[~match], conf[~match],
                                         cls_conf[~match], cls_id[~match])
    return np.asarray(out, np.float32)


def get_batch_statistics(detections: List[np.ndarray],
                         gt_boxes: List[np.ndarray],
                         iou_threshold: float = 0.5):
    """Per-image TP flags (reference util_yolo.py:164-200).
    gt_boxes[i]: (K, 5) [cls, x1, y1, x2, y2]."""
    stats = []
    for dets, gts in zip(detections, gt_boxes):
        if len(dets) == 0:
            continue
        tp = np.zeros(len(dets), np.float32)
        if len(gts):
            matched = []
            for d_idx, det in enumerate(dets):
                if len(matched) == len(gts):
                    break
                if det[6] not in gts[:, 0]:
                    continue
                ious = box_iou(det[None, :4], gts[:, 1:])[0]
                ious[[i for i in range(len(gts))
                      if gts[i, 0] != det[6] or i in matched]] = -1
                best = int(np.argmax(ious))
                if ious[best] >= iou_threshold:
                    tp[d_idx] = 1.0
                    matched.append(best)
        stats.append((tp, dets[:, 4], dets[:, 6]))
    return stats


def compute_ap(recall: np.ndarray, precision: np.ndarray) -> float:
    """All-point interpolated AP (reference util_yolo.py:136-161)."""
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def ap_per_class(tp: np.ndarray, conf: np.ndarray, pred_cls: np.ndarray,
                 target_cls: Sequence) -> dict:
    """precision/recall/AP/F1 per class (reference util_yolo.py:81-133)."""
    order = np.argsort(-conf)
    tp, conf, pred_cls = tp[order], conf[order], pred_cls[order]
    classes = np.unique(target_cls)
    p, r, ap = [], [], []
    for c in classes:
        mask = pred_cls == c
        n_gt = int((np.asarray(target_cls) == c).sum())
        n_p = int(mask.sum())
        if n_p == 0 and n_gt == 0:
            continue
        if n_p == 0 or n_gt == 0:
            p.append(0.0); r.append(0.0); ap.append(0.0)
            continue
        fpc = np.cumsum(1 - tp[mask])
        tpc = np.cumsum(tp[mask])
        recall = tpc / (n_gt + 1e-16)
        precision = tpc / (tpc + fpc)
        r.append(float(recall[-1]))
        p.append(float(precision[-1]))
        ap.append(compute_ap(recall, precision))
    p, r, ap = map(np.asarray, (p, r, ap))
    f1 = 2 * p * r / (p + r + 1e-16)
    return {"precision": p, "recall": r, "AP": ap, "f1": f1,
            "classes": classes, "mAP": float(ap.mean()) if len(ap) else 0.0}

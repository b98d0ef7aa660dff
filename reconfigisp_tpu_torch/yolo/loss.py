"""YOLOv3 detection loss: decode and target building on the head's grid.

Counterpart of reconfigisp_tpu/yolo/loss.py (reference
codes/models/modules/yolo_v3_net.py:107-205 and util_yolo.py:286-340).
Labels are a fixed (N, B, 6) tensor [valid, cls, cx, cy, w, h] (normalized);
targets are written by scatters of static shape, so the loss runs inside the
search step with no host sync.

The JAX package writes a cell's targets with `.at[...].set(mode="drop")`:
invalid rows go to an out-of-range batch index and are dropped, and when
several valid rows of an image land on one cell and anchor, the last one's
values stay (XLA's scatter on the CPU).  A scatter with repeated indices has
no defined result on CUDA, so here that rule is explicit: a row is written
only if it is valid and no later valid row of its image has the same
(anchor, gj, gi); the others go to one spare slot past the grid, which is
cut off after the write.  Writes of a constant (objectness 1, the class's 1,
the ignore mask's 0) need no such rule.

Under a data group (`group=`) the loss is this rank's additive share of the
global batch's: the object count that normalises every term, and the gate
of a batch with no box, are the whole batch's, summed over the group
without gradient (utils/losses.global_count), so the shares add up to the
loss of the whole batch.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from reconfigisp_tpu_torch.utils.losses import global_count


_ANCHORS = {}   # (anchors, stride, device) -> _anchors_per_cell


def _anchors_per_cell(anchors, stride: float, device) -> torch.Tensor:
    """Anchors in grid units, f32 divided as JAX divides them (by the f32
    of the python stride; a CUDA division by a scalar would multiply by its
    reciprocal).  Made once per device, so that a captured CUDA graph
    copies nothing from the host, and never as an inference tensor, which
    autograd could not save."""
    key = (tuple(map(tuple, anchors)), stride, torch.device(device))
    if key not in _ANCHORS:
        a = np.asarray(anchors, np.float32) / np.float32(stride)
        with torch.inference_mode(False):
            _ANCHORS[key] = torch.from_numpy(a).to(device)
    return _ANCHORS[key]


def decode_head(head: torch.Tensor, anchors: Sequence[Tuple[float, float]],
                img_size: int):
    """Raw head (N,A,Gh,Gw,5+C) -> (boxes (N,A,Gh,Gw,4) xywh in image
    pixels, conf (N,A,Gh,Gw), class probabilities (N,A,Gh,Gw,C)).

    Standard YOLOv3 decode (reference yolo_v3_net.py:150-195):
    xy = sigmoid(txy) + grid, wh = anchor * exp(twh), conf/cls = sigmoid."""
    _, _, gh, gw, _ = head.shape
    stride = img_size / gh
    dev = head.device
    gy = torch.arange(gh, dtype=torch.float32, device=dev)[:, None]
    gx = torch.arange(gw, dtype=torch.float32, device=dev)[None, :]
    anchors_arr = _anchors_per_cell(anchors, stride, dev)
    x = (torch.sigmoid(head[..., 0]) + gx) * stride
    y = (torch.sigmoid(head[..., 1]) + gy) * stride
    w = anchors_arr[:, 0][None, :, None, None] * torch.exp(head[..., 2]) * stride
    h = anchors_arr[:, 1][None, :, None, None] * torch.exp(head[..., 3]) * stride
    conf = torch.sigmoid(head[..., 4])
    cls = torch.sigmoid(head[..., 5:])
    return torch.stack([x, y, w, h], -1), conf, cls


def _wh_iou(wh1: torch.Tensor, wh2: torch.Tensor) -> torch.Tensor:
    """IoU of width/height pairs (anchor matching, reference
    util_yolo.py:212)."""
    inter = torch.minimum(wh1[..., 0], wh2[..., 0]) * \
        torch.minimum(wh1[..., 1], wh2[..., 1])
    union = wh1[..., 0] * wh1[..., 1] + wh2[..., 0] * wh2[..., 1] - inter
    return inter / torch.clamp(union, min=1e-9)


def _scatter(n_cells: int, shape, base: float, index: torch.Tensor,
             value) -> torch.Tensor:
    """A tensor of `shape` filled with `base`, `value` written at the flat
    `index`; index n_cells is the spare slot, cut off."""
    flat = torch.full((n_cells + 1,), base, dtype=torch.float32,
                      device=index.device)
    if not torch.is_tensor(value):
        value = torch.full(index.shape, float(value), dtype=torch.float32,
                           device=index.device)
    flat.scatter_(0, index.reshape(-1), value.reshape(-1))
    return flat[:n_cells].view(shape)


def last_writes(cell: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(N, B) mask of the rows whose values a cell keeps: valid rows that
    no later valid row of the same image writes over (same `cell`)."""
    b = cell.shape[1]
    later = torch.triu(torch.ones(b, b, dtype=torch.bool,
                                  device=cell.device), 1)
    overwritten = ((cell[:, :, None] == cell[:, None, :])
                   & valid[:, None, :] & later).any(-1)
    return valid & ~overwritten


def build_targets(labels: torch.Tensor, anchors_grid: torch.Tensor,
                  gh: int, gw: int, n_cls: int,
                  ignore_thres: float = 0.5) -> dict:
    """labels (N,B,6) [valid, cls, cx, cy, w, h] normalized -> target
    tensors on the (N,A,Gh,Gw) grid (reference util_yolo.py:286-340): obj,
    noobj, tx, ty, tw, th, and tcls (N,A,Gh,Gw,C)."""
    n, b, _ = labels.shape
    a = anchors_grid.shape[0]
    dev = labels.device
    valid = labels[..., 0] > 0.5                      # (N,B)
    cls_idx = labels[..., 1].to(torch.int64)
    gx = labels[..., 2] * gw
    gy = labels[..., 3] * gh
    tw_boxes = labels[..., 4] * gw
    th_boxes = labels[..., 5] * gh
    gx_int = gx.to(torch.int32)                       # toward zero, as JAX
    gy_int = gy.to(torch.int32)
    gi = torch.clamp(gx_int, 0, gw - 1).to(torch.int64)
    gj = torch.clamp(gy_int, 0, gh - 1).to(torch.int64)

    ious = _wh_iou(torch.stack([tw_boxes, th_boxes], -1)[:, :, None, :],
                   anchors_grid[None, None, :, :])    # (N,B,A)
    best_a = torch.argmax(ious, dim=-1)               # first of ties

    n_cells = n * a * gh * gw
    batch_idx = torch.arange(n, device=dev)[:, None].expand(n, b)
    cell = ((batch_idx * a + best_a) * gh + gj) * gw + gi     # (N,B)
    # the last valid row of an image on a cell wins, as JAX's scatter has it
    spare = torch.full_like(cell, n_cells)
    write = torch.where(last_writes(cell, valid), cell, spare)
    hit = torch.where(valid, cell, spare)

    grid = (n, a, gh, gw)
    obj = _scatter(n_cells, grid, 0.0, hit, 1.0)
    tx = _scatter(n_cells, grid, 0.0, write, gx - gx_int.to(torch.float32))
    ty = _scatter(n_cells, grid, 0.0, write, gy - gy_int.to(torch.float32))
    tw = _scatter(n_cells, grid, 0.0, write, torch.log(torch.clamp(
        tw_boxes / anchors_grid[best_a, 0], min=1e-9)))
    th = _scatter(n_cells, grid, 0.0, write, torch.log(torch.clamp(
        th_boxes / anchors_grid[best_a, 1], min=1e-9)))
    # a class index outside [0, C) is dropped, as JAX drops it
    has_cls = valid & (cls_idx >= 0) & (cls_idx < n_cls)
    cls_cell = torch.where(has_cls, cell * n_cls + cls_idx,
                           torch.full_like(cell, n_cells * n_cls))
    tcls = _scatter(n_cells * n_cls, (*grid, n_cls), 0.0, cls_cell, 1.0)

    # noobj: off at object cells and wherever any target's anchor IoU
    # exceeds ignore_thres (reference util_yolo.py:322-327)
    aa = torch.arange(a, device=dev)
    cell_a = ((batch_idx[..., None] * a + aa) * gh + gj[..., None]) * gw \
        + gi[..., None]                               # (N,B,A)
    ignore = (ious > ignore_thres) & valid[..., None]
    noobj = _scatter(n_cells, grid, 1.0, torch.where(
        ignore, cell_a, torch.full_like(cell_a, n_cells)), 0.0)
    noobj = noobj * (1.0 - obj)

    return {"obj": obj, "noobj": noobj, "tx": tx, "ty": ty, "tw": tw,
            "th": th, "tcls": tcls}


def _bce(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.maximum(logits, torch.zeros_like(logits)) \
        - logits * target + torch.log1p(torch.exp(-torch.abs(logits)))


def yolo_head_loss(head: torch.Tensor, anchors, labels: torch.Tensor,
                   img_size: int, *, obj_scale: float = 1.0,
                   noobj_scale: float = 100.0,
                   ignore_thres: float = 0.5, group=None) -> torch.Tensor:
    """Multi-part loss of one scale (reference yolo_v3_net.py:196-205): MSE
    on x/y/w/h at object cells, BCE on objectness (obj + scaled noobj), BCE
    on class probabilities; objectness alone where the batch has no box.
    With a data group, this rank's share (module docstring)."""
    _, _, gh, gw, f = head.shape
    stride = img_size / gh
    anchors_grid = _anchors_per_cell(anchors, stride, head.device)
    t = build_targets(labels, anchors_grid, gh, gw, f - 5, ignore_thres)

    px = torch.sigmoid(head[..., 0])
    py = torch.sigmoid(head[..., 1])
    pw, ph = head[..., 2], head[..., 3]
    obj, noobj = t["obj"], t["noobj"]
    count = global_count(torch.sum(obj), group)
    n_obj = torch.clamp(count, min=1.0)

    loss_x = torch.sum(obj * (px - t["tx"]) ** 2) / n_obj
    loss_y = torch.sum(obj * (py - t["ty"]) ** 2) / n_obj
    loss_w = torch.sum(obj * (pw - t["tw"]) ** 2) / n_obj
    loss_h = torch.sum(obj * (ph - t["th"]) ** 2) / n_obj
    conf_bce = _bce(head[..., 4], obj)
    loss_conf = (obj_scale * torch.sum(obj * conf_bce)
                 + noobj_scale * torch.sum(noobj * conf_bce)) / n_obj
    cls_bce = _bce(head[..., 5:], t["tcls"])
    loss_cls = torch.sum(obj[..., None] * cls_bce) / n_obj

    # the guard of a batch with no box (reference
    # darts_yolo_model.py:147-152): a where, so its gradient is JAX's
    has_obj = count > 0
    total = loss_x + loss_y + loss_w + loss_h + loss_conf + loss_cls
    return torch.where(has_obj, total, loss_conf)


def yolo_loss(heads: List[tuple], labels: torch.Tensor, img_size: int,
              **kw) -> torch.Tensor:
    """Sum of the per-scale losses over YoloNet's heads."""
    total = 0.0
    for head, anchors, _ in heads:
        total = total + yolo_head_loss(head, anchors, labels, img_size, **kw)
    return total

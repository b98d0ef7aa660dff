"""Training objectives.

Counterpart of reconfigisp_tpu/utils/losses.py: l1 and l2, the mixed
local/global loss (reference codes/utils/util_loss.py:26-64) and the
latency-aware loss (util_loss.py:8-23).  Images are NHWC, as at every public
function of the port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def l2(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def latency_loss(pred, target, latency, target_latency, w, fidelity_loss=l2):
    """fidelity * (latency / target)^w -> (loss, latency_term).  Raises
    when the latency is None: an op of the network has no entry in the
    per-op latency table (registry.LATENCY_MS_PER_MP)."""
    if latency is None:
        raise ValueError(
            "the latency loss needs the network's latency, which is None "
            "while an op has no entry in registry.LATENCY_MS_PER_MP")
    fid = fidelity_loss(pred, target)
    term = (latency / target_latency) ** w
    return fid * term, term


def downsample_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """(N, H, W, C) -> (N, *size, C) as jax.image.resize(..., "bilinear"),
    whose default antialias=True widens the triangle filter by the scale
    when it shrinks, as F.interpolate's antialias does."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=size, mode="bilinear",
                      align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1)


def local_global_loss(pred, target, glb_flag):
    """Mixed local/global squared error (reference util_loss.py:26-64).

    Local samples (glb_flag < 1) are gain-matched per image and channel
    before the loss (the gain, a clamped ratio of means, carries no
    gradient); global samples compare 1/4-scale bilinear downsamples.  Both
    parts are weighted by masks over the batch, so no sample is indexed
    out."""
    n = pred.shape[0]
    glb_flag = torch.as_tensor(glb_flag, device=pred.device)
    loc_mask = (glb_flag < 1).to(pred.dtype).reshape(n, 1, 1, 1)
    glb_mask = 1.0 - loc_mask

    with torch.no_grad():
        in_mean = torch.clamp(pred.mean(dim=(1, 2), keepdim=True), 0) + 1e-6
        gt_mean = target.mean(dim=(1, 2), keepdim=True)
        gain = torch.clamp(gt_mean / in_mean, 0.5, 2.0)
    per_px_loc = (pred * gain - target) ** 2
    loss_loc = torch.sum(per_px_loc * loc_mask) / torch.clamp(
        loc_mask.sum() * per_px_loc[0].numel(), min=1.0)

    h, w = pred.shape[1], pred.shape[2]
    small = (max(h // 4, 1), max(w // 4, 1))
    per_px_glb = (downsample_bilinear(pred, small)
                  - downsample_bilinear(target, small)) ** 2
    loss_glb = torch.sum(per_px_glb * glb_mask) / torch.clamp(
        glb_mask.sum() * per_px_glb[0].numel(), min=1.0)
    return loss_loc + loss_glb


def make_criterion(loss_type: str, train_opt: dict | None = None):
    """String -> loss fn f(pred, target, *, latency=None, glb_flag=None),
    as the reference dispatches them (darts_model.py:56-77)."""
    train_opt = train_opt or {}

    if loss_type == "l1":
        return lambda pred, target, **kw: l1(pred, target)
    if loss_type == "l2":
        return lambda pred, target, **kw: l2(pred, target)
    if loss_type == "local_global_l2":
        return lambda pred, target, glb_flag=None, **kw: local_global_loss(
            pred, target, glb_flag)
    if loss_type == "l2_latency":
        w = train_opt.get("w", 1.0)
        tl = train_opt.get("target_latency", 1.0)
        return lambda pred, target, latency=None, **kw: latency_loss(
            pred, target, latency, tl, w)[0]
    raise ValueError(f"unknown pixel_criterion {loss_type!r}")

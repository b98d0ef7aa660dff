"""Seeded planted scenes: smooth colour fields under a camera cast, their
RGGB mosaics with shot and read noise, and the target rendered from the
clean mosaic (the planted workload of configs/planted_search.yaml: Malvar
demosaic, manual white balance and gamma at fixed parameters).

Everything is drawn on the device from one torch.Generator, in a few large
calls: a coarse uniform field bilinearly upsampled, and Gaussian noise.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import ops


def scenes(gen, n: int, h: int, w: int, coarse: int, device):
    """(n, h, w, 3) BGR in [0, 1], smooth at the scale of `coarse` pixels."""
    field = torch.rand((n, 3, max(h // coarse, 1), max(w // coarse, 1)),
                       generator=gen, device=device)
    up = F.interpolate(field, size=(h, w), mode="bilinear",
                       align_corners=False)
    return up.permute(0, 2, 3, 1)


def mosaic(bgr):
    """(n, h, w, 3) BGR -> (n, h, w, 1) RGGB."""
    out = torch.empty(bgr.shape[:3] + (1,), dtype=bgr.dtype, device=bgr.device)
    out[:, 0::2, 0::2, 0] = bgr[:, 0::2, 0::2, 2]
    out[:, 0::2, 1::2, 0] = bgr[:, 0::2, 1::2, 1]
    out[:, 1::2, 0::2, 0] = bgr[:, 1::2, 0::2, 1]
    out[:, 1::2, 1::2, 0] = bgr[:, 1::2, 1::2, 0]
    return out


def captures(gen, n: int, h: int, w: int, p: dict, device):
    """-> (noisy mosaic, clean mosaic): the scene under p["cast"], its
    mosaic, and the mosaic with noise of std sqrt(shot^2 clean + read^2),
    clipped to [0, 1]."""
    cast = torch.tensor(p["cast"], device=device)
    lit = torch.clamp(scenes(gen, n, h, w, p["coarse"], device) * cast, 0, 1)
    clean = mosaic(lit)
    sigma = torch.sqrt(p["shot"] ** 2 * clean + p["read"] ** 2)
    noise = torch.randn(clean.shape, generator=gen, device=device)
    return torch.clamp(clean + sigma * noise, 0.0, 1.0), clean


def render(clean, p: dict):
    """The planted target of a clean mosaic: Malvar, wb_manual at
    p["wb01"], gamma at p["gamma01"], in [0, 1]."""
    n = clean.shape[0]
    wb = torch.tensor([p["wb01"]], device=clean.device).expand(n, 3)
    g = torch.tensor([[p["gamma01"]]], device=clean.device).expand(n, 1)
    x = ops.wb_manual(ops.demosaic(clean, "malvar"), wb)
    return torch.clamp(ops.gamma(x, g), 0.0, 1.0)

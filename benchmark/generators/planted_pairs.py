"""A pool of seeded training and validation batch pairs of planted crops
for the search step: every crop differs.  Traffic parameters: pairs, batch,
crop, coarse, cast, shot, read, wb01, gamma01 (lib/scenes.py)."""

from __future__ import annotations

import torch

from benchmark.lib import scenes


def make(p: dict, seed: int, device) -> dict:
    """-> {"noisy": (pairs, 2, batch, crop, crop, 1), "gt": (pairs, 2,
    batch, crop, crop, 3)}; [i, 0] is pair i's training batch, [i, 1] its
    validation batch."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n = p["pairs"] * 2 * p["batch"]
    noisy, clean = scenes.captures(gen, n, p["crop"], p["crop"], p, device)
    gt = scenes.render(clean, p)
    shape = (p["pairs"], 2, p["batch"], p["crop"], p["crop"])
    return {"noisy": noisy.reshape(*shape, 1), "gt": gt.reshape(*shape, 3)}

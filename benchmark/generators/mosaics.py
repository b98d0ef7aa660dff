"""A pool of seeded full-frame mosaics, served in turn by one client in a
closed loop.  Traffic parameters: frames (the pool), height, width, coarse,
cast, shot, read (lib/scenes.py)."""

from __future__ import annotations

import torch

from benchmark.lib import scenes


def make(p: dict, seed: int, device) -> dict:
    """-> {"pool": (frames, 1, height, width, 1)}, one frame at a time to
    bound the memory of the draw."""
    gen = torch.Generator(device=device).manual_seed(seed)
    pool = torch.stack([
        scenes.captures(gen, 1, p["height"], p["width"], p, device)[0]
        for _ in range(p["frames"])])
    return {"pool": pool}

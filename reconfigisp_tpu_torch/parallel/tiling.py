"""Tiled full-resolution inference with feathered blending.

Counterpart of reconfigisp_tpu/parallel/tiling.py:24-96.  Tiles are taken in
the same order (tile position outer, image inner) and processed in groups of
`chunk` positions by a Python loop; each group's outputs are blended into
the frame at once, so no stack of all tiles is ever held.  The last group
is not zero-padded; the blend is the JAX one, term for term.

Over a space group (`group=`, the mesh's space axis; the counterpart of the
tile program under the JAX mesh, __graft_entry__.dryrun_multichip check 3)
rank s of the group runs every size-th group of positions from the s-th,
blends them into zeros, and `out` and `count` are SUM-reduced over the
group before the divide: the whole frame's blend, up to the order of the
sums.

Each group of positions is the span `serve.chunk`, and its accumulate, like
the final divide, the span `serve.blend` (utils/tracing.py).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from reconfigisp_tpu_torch.parallel import mesh as meshlib
from reconfigisp_tpu_torch.utils import tracing


def feather_mask(size, edge) -> np.ndarray:
    """All-ones map whose `edge`-wide borders ramp linearly to ~0
    (reference util_path_restore.py:47-64)."""
    h, w = size
    eh, ew = edge
    if eh > h // 2 or ew > w // 2:
        raise ValueError(f"feather edge {edge} too wide for tile {size}")
    m = np.ones((h, w), np.float32)
    for i in range(eh):
        v = (i + 1) / (eh + 1)
        m[i, :] = v
        m[-1 - i, :] = v
    for j in range(ew):
        v = (j + 1) / (ew + 1)
        m[:, j] = np.minimum(m[:, j], v)
        m[:, -1 - j] = np.minimum(m[:, -1 - j], v)
    return m


def tile_positions(total: int, size: int, stride: int) -> list:
    """Overlapping grid start positions (reference util_path_restore.py:88-89)."""
    return list(range(0, total - size, stride)) + [total - size]


def tiled_apply(fn: Callable, x: torch.Tensor, *, patch: int, stride: int,
                chunk: int = 4, out_channels: int = 3,
                group=None) -> torch.Tensor:
    """Apply fn over overlapping patches of x (N,H,W,C) and blend.

    fn takes and returns a batch of tiles (chunk*N, patch, patch, C); patch,
    stride, H and W must be even to keep the RGGB phase.  With a space
    `group` the groups of positions are dealt out over its ranks (module
    docstring); every rank returns the whole blend."""
    n, H, W, c = x.shape
    if patch % 2 or stride % 2 or H % 2 or W % 2:
        raise ValueError("RGGB alignment needs even patch, stride, H and W")
    eh = (patch - stride) // 2
    mask = torch.from_numpy(feather_mask((patch, patch), (eh, eh))).to(
        x.device)[None, :, :, None]
    positions = [(y0, x0) for y0 in tile_positions(H, patch, stride)
                 for x0 in tile_positions(W, patch, stride)]

    out = count = None
    step = max(1, chunk)
    starts = range(0, len(positions), step)
    if group is not None:
        starts = starts[dist.get_rank(group)::dist.get_world_size(group)]
    for g in starts:
        with tracing.span("serve.chunk"):
            here = positions[g:g + step]
            tiles = torch.cat([x[:, y0:y0 + patch, x0:x0 + patch, :]
                               for (y0, x0) in here], dim=0)
            outs = fn(tiles)
            with tracing.span("serve.blend", device=x.is_cuda):
                if out is None:
                    out = torch.zeros((n, H, W, out_channels),
                                      dtype=outs.dtype, device=x.device)
                    count = torch.zeros((1, H, W, 1), dtype=outs.dtype,
                                        device=x.device)
                for k, (y0, x0) in enumerate(here):
                    out[:, y0:y0 + patch, x0:x0 + patch, :] += \
                        outs[k * n:(k + 1) * n] * mask
                    count[:, y0:y0 + patch, x0:x0 + patch, :] += mask
    if group is not None:
        if out is None:  # more ranks than groups of positions
            out = torch.zeros((n, H, W, out_channels), dtype=x.dtype,
                              device=x.device)
            count = torch.zeros((1, H, W, 1), dtype=x.dtype, device=x.device)
        meshlib.all_reduce(out, group)
        meshlib.all_reduce(count, group)
    with tracing.span("serve.blend", device=x.is_cuda):
        return out / count

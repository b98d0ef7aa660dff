"""Plain reference of a served SID frame: the tiled pipeline and its blend.

The pipeline is an architecture string's ops in order (SID_test.yaml's
Bayer_01_Demosaic_03_sRGB_01_13_11: RGGB pack, Path-Restore-14L, pixel
shuffle, Malvar demosaic, gamma, the 30-term quadratic colour transform,
manual white balance), each op's parameters the sigmoid of its step's
logits, the learned modules shared by op name.  A frame is cut into
patch x patch tiles at `stride` (the last row and column of tiles flush with
the frame's edge), each tile goes through the pipeline, and the tiles are
blended with a feather mask: 1 inside, falling linearly to 1 / (e + 1) over
the e = (patch - stride) / 2 pixels next to each edge, a corner taking the
lower of its two ramps (Path-Restore's util_path_restore.py).  The output is
the masked sum over the mask's sum.

Tiles go through in groups of `chunk`, another grouping than the program's,
so the comparison does not rest on one convolution algorithm.
"""

from __future__ import annotations

import torch

from benchmark.reference import ops, zoo
from benchmark.reference.search import apply_op


def starts(total: int, size: int, stride: int) -> list:
    """Tile origins along one axis."""
    return list(range(0, total - size, stride)) + [total - size]


def feather(patch: int, edge: int, device) -> torch.Tensor:
    ramp = torch.ones(patch, device=device)
    for i in range(edge):
        v = (i + 1) / (edge + 1)
        ramp[i] = v
        ramp[patch - 1 - i] = v
    return torch.minimum(ramp[:, None], ramp[None, :])


def pipeline(architecture, tiles, weights, logits, storage):
    """(N, h, w, 1) mosaic tiles -> (N, h, w, 3) BGR.  logits: {step index:
    (P,)} for the steps whose op has parameters; weights: {op: convs}."""
    x = tiles
    for i, op in enumerate(zoo.parse(architecture)):
        params = (ops.sigmoid_params(logits[i], x.shape[0]) if i in logits
                  else None)
        x = apply_op(op, x, params, weights, False, storage)
    return x


@torch.no_grad()
def serve_frame(architecture, mosaic, weights, logits, *, patch: int,
                stride: int, storage: str = "f32",
                chunk: int = 8) -> torch.Tensor:
    """mosaic (1, H, W, 1) -> (1, H, W, 3), float32."""
    _, h, w, _ = mosaic.shape
    mask = feather(patch, (patch - stride) // 2, mosaic.device)
    out = torch.zeros((h, w, 3), device=mosaic.device)
    den = torch.zeros((h, w), device=mosaic.device)
    origins = [(y, x) for y in starts(h, patch, stride)
               for x in starts(w, patch, stride)]
    for g in range(0, len(origins), chunk):
        group = origins[g:g + chunk]
        tiles = torch.cat([mosaic[:, y:y + patch, x:x + patch]
                           for y, x in group])
        got = pipeline(architecture, tiles, weights, logits, storage).float()
        for k, (y, x) in enumerate(group):
            out[y:y + patch, x:x + patch] += got[k] * mask[:, :, None]
            den[y:y + patch, x:x + patch] += mask
    return (out / den[:, :, None])[None]

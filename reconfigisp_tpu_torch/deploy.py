"""Serving entry point for fixed ISP pipelines.

Counterpart of reconfigisp_tpu/deploy.py:41-61 (make_serving_fn); the
exported serving artifact is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from reconfigisp_tpu_torch.parallel.tiling import tiled_apply
from reconfigisp_tpu_torch.pipeline import Pipeline, resolve_device


def make_serving_fn(pipe: Pipeline, *, patch: Optional[int] = None,
                    stride: Optional[int] = None, chunk: int = 32,
                    device=None):
    """mosaic -> sRGB closure over the pipeline, run in inference mode.

    With `patch` set, frames go through the feathered tiled engine
    (parallel/tiling.py); `stride` defaults to patch (no overlap) and `chunk`
    is the number of tile positions per pipeline call.  `device` defaults to
    cuda and must be the pipeline's; inputs are moved to it."""
    dev = resolve_device(device)
    if pipe.device != dev:
        raise ValueError(f"pipeline is on {pipe.device}, serving on {dev}")
    st = int(stride or patch or 0)

    @torch.inference_mode()
    def serve(x) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float32, device=dev)
        if patch:
            return tiled_apply(pipe, x, patch=int(patch), stride=st,
                               chunk=chunk)
        return pipe(x)

    return serve

"""reconfigisp_tpu_torch — the PyTorch/CUDA port of reconfigisp_tpu.

The JAX package (`reconfigisp_tpu`) stays the reference; this package computes
the same functions with PyTorch on an NVIDIA GPU, and every Pallas kernel on a
ported path becomes a CUDA kernel written for Hopper (`csrc/`).  It imports
neither JAX nor the JAX package.

Public contract (the JAX package's):
  * images are NHWC at every public function (internals run NCHW);
  * sRGB channel order is BGR;
  * Bayer mosaics are (N, H, W, 1), RGGB, values in [0, 1];
  * module parameters are stored as logits and squashed with sigmoid.

Entry points (`Pipeline`, `deploy.make_serving_fn`) run on `cuda` unless the
caller passes `device="cpu"`, and raise when CUDA is asked for but absent.
"""

from reconfigisp_tpu_torch.version import __version__
from reconfigisp_tpu_torch.registry import OpSpec, get_op, pool
from reconfigisp_tpu_torch.pipeline import Pipeline, parse_architecture

__all__ = [
    "__version__",
    "OpSpec",
    "get_op",
    "pool",
    "Pipeline",
    "parse_architecture",
]

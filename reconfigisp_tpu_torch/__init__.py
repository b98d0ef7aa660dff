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
caller passes `device="cpu"`, and raise when CUDA is asked for but absent;
`search.IspTrainer` trains a Pipeline where it lies.
"""

import importlib

from reconfigisp_tpu_torch.version import __version__

# The names below are imported at first use (PEP 562), so that importing a
# submodule, such as deploy to load a serving artifact, does not import the
# op zoo.
_LAZY = {"OpSpec": "registry", "get_op": "registry", "pool": "registry",
         "Pipeline": "pipeline", "parse_architecture": "pipeline"}


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module = importlib.import_module(f"{__name__}.{_LAZY[name]}")
    return getattr(module, name)


__all__ = [
    "__version__",
    "OpSpec",
    "get_op",
    "pool",
    "Pipeline",
    "parse_architecture",
]

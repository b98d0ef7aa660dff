"""Storage precision of the learned CNN stacks.

Counterpart of reconfigisp_tpu/precision.py.  The policy sets the dtype in
which the Path-Restore stack keeps its inter-layer activations and runs its
convolutions: float32 (the default, and the dtype of every parity test) or
bfloat16, which halves the activation bytes and reaches the tensor cores.
Eager PyTorch reads the policy at call time, so the JAX package's
`policy_jit` has no counterpart; torch.export reads it at trace time
(deploy.export_pipeline).

    with precision.cnn_storage("bf16"):
        y = pipe(x)

or set RECONFIGISP_CNN_STORAGE=bf16 to flip the process-wide default, read
at import as the JAX package reads it (an unknown name gives float32).
"""

from __future__ import annotations

import contextlib
import contextvars
import os

import torch

_DTYPES = {"f32": torch.float32, "float32": torch.float32,
           "bf16": torch.bfloat16, "bfloat16": torch.bfloat16}

_default = os.environ.get("RECONFIGISP_CNN_STORAGE", "f32")
_current = contextvars.ContextVar(
    "cnn_storage", default=_DTYPES.get(_default, torch.float32))


def cnn_storage_dtype() -> torch.dtype:
    """Storage dtype for CNN inter-layer activations."""
    return _current.get()


@contextlib.contextmanager
def cnn_storage(name_or_dtype):
    """Scoped storage-dtype override: 'f32' | 'bf16' | a torch dtype."""
    dt = (_DTYPES[name_or_dtype] if isinstance(name_or_dtype, str)
          else name_or_dtype)
    token = _current.set(dt)
    try:
        yield
    finally:
        _current.reset(token)

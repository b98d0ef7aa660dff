"""The run's environment: cache directories, the card, precision flags and
the guard against the JAX package."""

from __future__ import annotations

import contextlib
import os
import subprocess
import sys
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "reconfigisp_tpu")


def cache_env(root: Path) -> None:
    """Fixed cache directories inside the checkout, for any build or
    compile cache the program or its libraries keep (the port's own kernels
    build into build/kernels there)."""
    base = root / "build" / "bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(base / sub)


def nvidia_smi() -> str:
    """The card's name and power limit, or why they could not be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as err:
        return f"unavailable ({err})"
    return out.strip().splitlines()[0]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 for cuDNN convolutions and cuBLAS matmuls within the block."""
    import torch
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old

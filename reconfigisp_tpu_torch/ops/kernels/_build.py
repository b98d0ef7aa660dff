"""Build, load and launch the hand-written CUDA kernels of csrc/.

Each source `csrc/<name>.cu` has a plain C interface and is compiled with
nvcc for Hopper (`sm_90a`) into `build/kernels/<name>-<hash>.so` at the root of
the checkout, then loaded with ctypes.  The hash covers the source and the
flags, so an edited source builds anew and an unchanged one is reused.  A
failed build raises: there is no fallback.

Every source exports `int <name>_forward(x, params, out, n, h, w, c,
stream)` over NHWC float32; `on_card` and `launch` are the routing and the
call that the kernel wrappers (ops/kernels/*.py) share.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

MAX_R = 7  # largest window radius of every kernel

_loaded: dict = {}


def nvcc() -> str:
    """The nvcc binary: on PATH, else under $CUDA_HOME or the toolkit's
    standard prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names) -> dict:
    """Compile every named source that is not built yet, all nvcc processes
    at once.  Returns {name: (seconds, compiler output)}; raises on a failed
    build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, lib, time.perf_counter())
    report = {}
    failures = []
    for name, (proc, tmp, lib, t0) in started.items():
        output, _ = proc.communicate()
        report[name] = (time.perf_counter() - t0, output)
        if proc.returncode == 0:
            os.replace(tmp, lib)
        else:
            os.unlink(tmp)
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{output}")
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


def on_card(op: str, x: torch.Tensor, params: torch.Tensor) -> bool:
    """Where `op` runs: False for a CPU tensor (the plain form), True for a
    CUDA tensor (the kernel, inside _vjp.WindowedKernel, whose backward is
    the plain form's gradient, so inputs that require grad run it too).
    Raises for any other device."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{op} runs on cuda or cpu, not {x.device}")
    return True


def launch(name: str, x: torch.Tensor, params: torch.Tensor,
           n_params: int) -> torch.Tensor:
    """Run csrc/<name>.cu on x's device and current stream and return its
    output.  The kernels read contiguous NHWC, so other strides are copied
    first.  Raises on operands a kernel does not take: (N, H, W, 1|3)
    float32 with H, W > MAX_R (one reflection) and N <= 65535 (the grid's
    z), and params (N, n_params) float32 on the same device; and on a CUDA
    error (a refused launch never runs, so it must be caught here)."""
    x, params = x.contiguous(), params.contiguous()
    if x.dtype != torch.float32 or params.dtype != torch.float32:
        raise TypeError(f"{name} kernel takes float32, got {x.dtype} "
                        f"and {params.dtype}")
    if x.ndim != 4 or x.shape[3] not in (1, 3):
        raise ValueError(f"{name} kernel takes (N, H, W, 1|3), got "
                         f"{tuple(x.shape)}")
    n, h, w, _ = x.shape
    if h <= MAX_R or w <= MAX_R or not 1 <= n <= 65535:
        raise ValueError(f"{name} kernel needs H, W > {MAX_R} and "
                         f"1 <= N <= 65535, got {tuple(x.shape)}")
    if tuple(params.shape) != (n, n_params):
        raise ValueError(f"params must be ({n}, {n_params}), got "
                         f"{tuple(params.shape)}")
    if params.device != x.device:
        raise ValueError("x and params must be on the same device")
    fn = getattr(load(name), f"{name}_forward")
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), params.data_ptr(), out.data_ptr(), *x.shape,
                stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    return out

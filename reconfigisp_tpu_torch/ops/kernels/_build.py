"""Build and load the hand-written CUDA kernels of csrc/.

Each source `csrc/<name>.cu` has a plain C interface and is compiled with
nvcc for Hopper (`sm_90a`) into `build/kernels/<name>-<hash>.so` at the root of
the checkout, then loaded with ctypes.  The hash covers the source and the
flags, so an edited source builds anew and an unchanged one is reused.  A
failed build raises: there is no fallback.
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

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

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

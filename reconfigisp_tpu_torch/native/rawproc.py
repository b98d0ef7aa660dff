"""ctypes bindings for the native rawproc library, beside their numpy forms.

Counterpart of reconfigisp_tpu/native/rawproc.py.  rawproc.cpp (a copy of
the JAX package's) is compiled with g++ at first use into
`build/native/rawproc-<hash>.so` at the root of the checkout, the hash
covering the source and the flags, so an edited source builds anew and an
unchanged one is reused.  The four entry points always call the library: a
failed build raises, and there is no silent fallback.  Each has a numpy form
(`*_plain`), the same function, which the tests hold the library against.
`HAVE_NATIVE` reports whether the library builds and loads here (it builds
it on first access).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().with_name("rawproc.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
             "-Wall")

_loaded: list = []


def _library_path(source: Path, build_dir: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes() + " ".join(CXX_FLAGS).encode())
    return build_dir / f"{source.stem}-{digest.hexdigest()[:16]}.so"


def library_path() -> Path:
    return _library_path(SOURCE, BUILD_DIR)


def compile_library(source: Path, build_dir: Path = BUILD_DIR) -> Path:
    """Compile a C++ source of this directory with g++ into
    `build_dir/<stem>-<hash>.so` unless it is built; raises on a failed
    build."""
    lib = _library_path(source, build_dir)
    if lib.exists():
        return lib
    build_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    cmd = ["g++", *CXX_FLAGS, "-o", tmp, str(source), "-lpthread"]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{source.stem} build failed ({' '.join(cmd)}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def build() -> Path:
    """Compile rawproc.cpp unless it is built; raises on a failed build."""
    return compile_library(SOURCE, BUILD_DIR)


def _lib() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    if _loaded:
        return _loaded[0]
    lib = ctypes.CDLL(str(build()))
    f32p = ctypes.POINTER(ctypes.c_float)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.rawproc_normalize_u16.argtypes = [
        u16p, ctypes.c_int64, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, f32p]
    lib.rawproc_crop_norm_batch.argtypes = [
        u16p, ctypes.c_int, ctypes.c_int, ctypes.c_int, i32p, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, f32p, ctypes.c_int]
    lib.rawproc_pack_rggb.argtypes = [f32p, ctypes.c_int, ctypes.c_int, f32p]
    lib.rawproc_feather_accumulate.argtypes = [
        f32p, i32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        f32p, f32p, f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.rawproc_version.restype = ctypes.c_int
    _loaded.append(lib)
    return lib


def __getattr__(name):
    if name == "HAVE_NATIVE":
        try:
            _lib()
        except (OSError, RuntimeError, subprocess.SubprocessError):
            return False
        return True
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def normalize_u16(raw: np.ndarray, black: float, white: float,
                  ratio: float = 1.0) -> np.ndarray:
    """(x - black) * ratio / (white - black), clipped to [0, 1]
    (the reference's black-level + exposure-ratio scaling,
    generate_rggb2bgr_imgs_SID_Sony.py:50-56)."""
    raw = np.ascontiguousarray(raw, np.uint16)
    out = np.empty(raw.shape, np.float32)
    _lib().rawproc_normalize_u16(
        _ptr(raw, ctypes.c_uint16), raw.size, black, white, ratio,
        _ptr(out, ctypes.c_float))
    return out


def normalize_u16_plain(raw: np.ndarray, black: float, white: float,
                        ratio: float = 1.0) -> np.ndarray:
    """normalize_u16's numpy form."""
    raw = np.ascontiguousarray(raw, np.uint16)
    return np.clip((raw.astype(np.float32) - black) * ratio / (white - black),
                   0.0, 1.0)


def crop_norm_batch(raws: np.ndarray, offsets: np.ndarray, size: int,
                    black: float, white: float, ratio: float = 1.0,
                    n_threads: int = 4) -> np.ndarray:
    """(N,H,W) uint16 + (N,2) offsets -> (N,size,size) float32, crops snapped
    to even offsets (RGGB phase)."""
    raws = np.ascontiguousarray(raws, np.uint16)
    offsets = np.ascontiguousarray(offsets, np.int32)
    n, h, w = raws.shape
    if offsets.shape != (n, 2) or not 0 < size <= min(h, w):
        raise ValueError(f"crops of {size} from {raws.shape} need (N, 2) "
                         f"offsets, got {offsets.shape}")
    out = np.empty((n, size, size), np.float32)
    _lib().rawproc_crop_norm_batch(
        _ptr(raws, ctypes.c_uint16), n, h, w,
        _ptr(offsets, ctypes.c_int32), size, black, white, ratio,
        _ptr(out, ctypes.c_float), n_threads)
    return out


def crop_norm_batch_plain(raws: np.ndarray, offsets: np.ndarray, size: int,
                          black: float, white: float,
                          ratio: float = 1.0) -> np.ndarray:
    """crop_norm_batch's numpy form."""
    raws = np.ascontiguousarray(raws, np.uint16)
    n, h, w = raws.shape
    out = np.empty((n, size, size), np.float32)
    for i in range(n):
        y0 = min(max(int(offsets[i, 0]) & ~1, 0), h - size)
        x0 = min(max(int(offsets[i, 1]) & ~1, 0), w - size)
        out[i] = np.clip(
            (raws[i, y0:y0 + size, x0:x0 + size].astype(np.float32) - black)
            * ratio / (white - black), 0.0, 1.0)
    return out


def pack_rggb(mosaic: np.ndarray) -> np.ndarray:
    """(H,W) float32 -> (4, H/2, W/2) RGGB planes."""
    mosaic = np.ascontiguousarray(mosaic, np.float32)
    h, w = mosaic.shape
    out = np.empty((4, h // 2, w // 2), np.float32)
    _lib().rawproc_pack_rggb(_ptr(mosaic, ctypes.c_float), h, w,
                             _ptr(out, ctypes.c_float))
    return out


def pack_rggb_plain(mosaic: np.ndarray) -> np.ndarray:
    """pack_rggb's numpy form."""
    mosaic = np.asarray(mosaic, np.float32)
    return np.stack([mosaic[0::2, 0::2], mosaic[0::2, 1::2],
                     mosaic[1::2, 0::2], mosaic[1::2, 1::2]])


def feather_accumulate(patches: np.ndarray, positions: np.ndarray,
                       mask: np.ndarray, H: int, W: int,
                       n_threads: int = 4):
    """Accumulate (P,h,w,C) patches at (P,2) positions with a feather mask ->
    (out (H,W,C), count (H,W)) — host-side patch2whole for frames too large
    to blend on-device (reference util_path_restore.py:108-134)."""
    patches = np.ascontiguousarray(patches, np.float32)
    positions = np.ascontiguousarray(positions, np.int32)
    mask = np.ascontiguousarray(mask, np.float32)
    p, ph, pw, c = patches.shape
    if (positions.shape != (p, 2) or mask.shape != (ph, pw) or p and (
            positions.min() < 0 or (positions[:, 0] + ph).max() > H
            or (positions[:, 1] + pw).max() > W)):
        raise ValueError(f"patches {patches.shape} at positions "
                         f"{positions.shape} with mask {mask.shape} must lie "
                         f"inside ({H}, {W})")
    out = np.zeros((H, W, c), np.float32)
    count = np.zeros((H, W), np.float32)
    _lib().rawproc_feather_accumulate(
        _ptr(patches, ctypes.c_float), _ptr(positions, ctypes.c_int32),
        p, ph, pw, c, _ptr(mask, ctypes.c_float),
        _ptr(out, ctypes.c_float), _ptr(count, ctypes.c_float),
        H, W, n_threads)
    return out, count


def feather_accumulate_plain(patches: np.ndarray, positions: np.ndarray,
                             mask: np.ndarray, H: int, W: int):
    """feather_accumulate's numpy form."""
    patches = np.asarray(patches, np.float32)
    mask = np.asarray(mask, np.float32)
    p, ph, pw, c = patches.shape
    out = np.zeros((H, W, c), np.float32)
    count = np.zeros((H, W), np.float32)
    for k in range(p):
        y0, x0 = positions[k]
        out[y0:y0 + ph, x0:x0 + pw] += patches[k] * mask[:, :, None]
        count[y0:y0 + ph, x0:x0 + pw] += mask
    return out, count

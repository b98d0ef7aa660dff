"""PNG read and write without cv2.

The OnePlus detection data (16-bit Bayer PNGs), the folder datasets' PNG
frames and the test CLI's outputs go through here, so the data path needs
no cv2.  `read` / `decode` give what `cv2.imread(path, cv2.IMREAD_UNCHANGED)`
gives: 8- or 16-bit samples in native byte order, a grey image as (H, W),
colour as BGR (H, W, 3).  `write` / `encode` write what
`cv2.imwrite` writes for the same arrays.  The IDAT stream is inflated with
Python's zlib; the row filters (None, Sub, Up, Average, Paeth) are undone by
native/pngfilter.cpp, built with g++ at first use into build/native/ as
native/rawproc.cpp is.  Interlaced, palette, alpha and sub-byte images
raise: the reader has one route, and no cv2 behind it.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from pathlib import Path

import numpy as np

from reconfigisp_tpu_torch.native.rawproc import compile_library

SOURCE = Path(__file__).resolve().parents[1] / "native" / "pngfilter.cpp"
SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples a pixel: grey, RGB
CHANNELS = {0: 1, 2: 3}
COLOUR_TYPE = {v: k for k, v in CHANNELS.items()}

_loaded: list = []


def _lib() -> ctypes.CDLL:
    if _loaded:
        return _loaded[0]
    lib = ctypes.CDLL(str(compile_library(SOURCE)))
    lib.png_unfilter.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ctypes.c_void_p]
    lib.png_unfilter.restype = ctypes.c_int64
    _loaded.append(lib)
    return lib


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + n]
        pos += 12 + n


def decode(data: bytes) -> np.ndarray:
    """PNG bytes -> the array cv2.imdecode(..., IMREAD_UNCHANGED) gives."""
    if not data.startswith(SIGNATURE):
        raise ValueError("not a PNG image: the port reads PNG (or .npy) "
                         "files only")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"tRNS":
            raise ValueError("PNG with a tRNS chunk: transparency by key "
                             "colour is not supported")
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    w, h, depth, colour, _, _, interlace = header
    if depth not in (8, 16) or colour not in CHANNELS or interlace:
        raise ValueError(
            f"PNG of bit depth {depth}, colour type {colour}, interlace "
            f"{interlace}: only non-interlaced 8- or 16-bit grey and RGB "
            f"are supported")
    c = CHANNELS[colour]
    bpp = c * depth // 8
    rowbytes = w * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < h * (rowbytes + 1):
        raise ValueError(f"PNG data holds {len(raw)} bytes, a {h}x{w} image "
                         f"needs {h * (rowbytes + 1)}")
    out = np.empty(h * rowbytes, np.uint8)
    bad = _lib().png_unfilter(raw, h, rowbytes, bpp, out.ctypes.data)
    if bad:
        raise ValueError(f"PNG row {bad - 1} has an unknown filter type")
    img = out.view(">u2").astype(np.uint16) if depth == 16 else out
    img = img.reshape(h, w, c)
    if c == 1:
        return img[..., 0]
    return np.ascontiguousarray(img[..., ::-1])   # BGR, as cv2 returns it


def read(path) -> np.ndarray:
    """A PNG file -> the array cv2.imread(path, IMREAD_UNCHANGED) gives."""
    with open(path, "rb") as f:
        return decode(f.read())


def _chunk(kind: bytes, body: bytes) -> bytes:
    crc = zlib.crc32(kind + body) & 0xFFFFFFFF
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", crc)


def encode(img: np.ndarray) -> bytes:
    """uint8 or uint16, (H, W), (H, W, 1) or BGR (H, W, 3) -> PNG bytes
    that decode as cv2.imwrite's file of `img` does: every row unfiltered,
    zlib at level 1."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNG holds uint8 or uint16 samples, not {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if c not in COLOUR_TYPE:
        raise ValueError(f"PNG of {c} channels: 1 or 3 are supported")
    if c == 3:
        img = img[..., ::-1]
    depth = 8 * img.dtype.itemsize
    rows = np.ascontiguousarray(img, ">u2" if depth == 16 else np.uint8)
    rows = rows.view(np.uint8).reshape(h, -1)
    filtered = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, COLOUR_TYPE[c], 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(filtered.tobytes(), 1))
            + _chunk(b"IEND", b""))


def write(path, img: np.ndarray) -> None:
    """Write `img` to a PNG file, as cv2.imwrite(path, img) does."""
    with open(path, "wb") as f:
        f.write(encode(img))

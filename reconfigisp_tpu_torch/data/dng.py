"""Pure-python DNG / TIFF-EP raw mosaic ingress.

A copy of reconfigisp_tpu/data/dng.py for the PyTorch port (numpy only; the
port imports nothing of the JAX package).  The reference's offline stage decodes camera files with rawpy — ARW/DNG ->
Bayer mosaic + black-level subtract + exposure scaling, and GT sRGB via
rawpy.postprocess (reference codes/data/preprocessing/
generate_rggb2bgr_imgs_SID_Sony.py:32-66).  rawpy is not available in this
environment, so this module implements the raw ingress natively:

  * a TIFF 6.0 / TIFF-EP IFD walker (II and MM byte orders, SubIFD chains)
  * uncompressed strip rasters at 8/16 bit and MSB-first bit-packed
    10/12/14-bit (the common DNG raw layouts; lossless-JPEG compressed DNGs
    are out of scope and raise a descriptive error)
  * the DNG raw tags: CFAPattern/CFARepeatPatternDim, BlackLevel,
    WhiteLevel, AsShotNeutral
  * `write_dng` — a minimal writer used for fixture generation and
    round-trip tests
  * `postprocess` — a documented stand-in for rawpy.postprocess: bilinear
    demosaic + white balance + sRGB gamma -> uint8 BGR ground truth

CLI: python -m reconfigisp_tpu_torch.data.dng <file.dng> <out.npy> converts a DNG
to the uint16 .npy mosaic layout data/preprocessing.py consumes.
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Optional

import numpy as np

# TIFF tag ids
_TAG_NEW_SUBFILE_TYPE = 254
_TAG_WIDTH = 256
_TAG_LENGTH = 257
_TAG_BITS = 258
_TAG_COMPRESSION = 259
_TAG_PHOTOMETRIC = 262
_TAG_STRIP_OFFSETS = 273
_TAG_SAMPLES_PER_PIXEL = 277
_TAG_ROWS_PER_STRIP = 278
_TAG_STRIP_BYTE_COUNTS = 279
_TAG_SUB_IFDS = 330
_TAG_TILE_WIDTH = 322
_TAG_CFA_REPEAT_DIM = 33421
_TAG_CFA_PATTERN = 33422
_TAG_DNG_VERSION = 50706
_TAG_BLACK_LEVEL = 50714
_TAG_WHITE_LEVEL = 50717
_TAG_AS_SHOT_NEUTRAL = 50728

_PHOTOMETRIC_CFA = 32803

# TIFF field types -> (struct fmt, size)
_TYPES = {1: ("B", 1), 3: ("H", 2), 4: ("I", 4), 5: ("II", 8),
          2: ("s", 1), 7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 10: ("ii", 8)}

_CFA_LETTER = {0: "R", 1: "G", 2: "B"}
_LETTER_CFA = {v: k for k, v in _CFA_LETTER.items()}


class DngError(ValueError):
    pass


def _read_ifd(f: BinaryIO, off: int, bo: str) -> dict:
    """-> {tag: value_or_list} for one IFD; appends 'next' offset."""
    f.seek(off)
    (n_entries,) = struct.unpack(bo + "H", f.read(2))
    entries = {}
    for _ in range(n_entries):
        tag, ftype, count = struct.unpack(bo + "HHI", f.read(8))
        raw = f.read(4)
        if ftype not in _TYPES:
            continue
        fmt, size = _TYPES[ftype]
        total = size * count
        if total > 4:
            (voff,) = struct.unpack(bo + "I", raw)
            here = f.tell()
            f.seek(voff)
            data = f.read(total)
            f.seek(here)
        else:
            data = raw[:total]
        if ftype == 2:  # ASCII
            entries[tag] = data.rstrip(b"\0").decode("ascii", "replace")
            continue
        if ftype in (5, 10):  # rational
            vals = struct.unpack(bo + fmt[0] * 2 * count, data)
            entries[tag] = [vals[2 * i] / (vals[2 * i + 1] or 1)
                            for i in range(count)]
            continue
        vals = struct.unpack(bo + fmt * count, data)
        entries[tag] = list(vals) if count > 1 else vals[0]
    (nxt,) = struct.unpack(bo + "I", f.read(4))
    entries["next"] = nxt
    return entries


def _walk_ifds(f: BinaryIO, bo: str, first: int):
    """Yield every IFD including SubIFD chains (DNG keeps the raw in a
    SubIFD of the thumbnail IFD)."""
    stack = [first]
    seen = set()
    while stack:
        off = stack.pop()
        if not off or off in seen:
            continue
        seen.add(off)
        ifd = _read_ifd(f, off, bo)
        yield ifd
        sub = ifd.get(_TAG_SUB_IFDS)
        if sub is not None:
            stack.extend(sub if isinstance(sub, list) else [sub])
        stack.append(ifd["next"])


def _unpack_bits(buf: bytes, bits: int, count: int) -> np.ndarray:
    """MSB-first bit-packed samples (DNG packs 10/12/14-bit rasters this
    way) -> uint16 array of `count` values."""
    data = np.frombuffer(buf, np.uint8)
    stream = np.unpackbits(data)[: count * bits]
    stream = stream.reshape(count, bits).astype(np.uint16)
    weights = (1 << np.arange(bits - 1, -1, -1)).astype(np.uint16)
    return (stream * weights).sum(axis=1, dtype=np.uint16)


def read_dng(path: str):
    """-> (mosaic uint16 (H, W), meta dict).

    meta: {'black_level': float, 'white_level': float, 'cfa': 'RGGB'-style
    string or None, 'bits': int, 'as_shot_neutral': list | None}.
    """
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) < 8 or head[:2] not in (b"II", b"MM"):
            raise DngError(f"{path}: not a TIFF/DNG file")
        bo = "<" if head[:2] == b"II" else ">"
        (magic,) = struct.unpack(bo + "H", head[2:4])
        if magic != 42:
            raise DngError(f"{path}: bad TIFF magic {magic}")
        (first,) = struct.unpack(bo + "I", head[4:8])

        raw_ifd = None
        best_pixels = -1
        for ifd in _walk_ifds(f, bo, first):
            if _TAG_WIDTH not in ifd or _TAG_LENGTH not in ifd:
                continue
            is_cfa = ifd.get(_TAG_PHOTOMETRIC) == _PHOTOMETRIC_CFA
            pixels = ifd[_TAG_WIDTH] * ifd[_TAG_LENGTH]
            # prefer the CFA IFD; otherwise the largest raster
            score = pixels + (1 << 62 if is_cfa else 0)
            if score > best_pixels:
                best_pixels = score
                raw_ifd = ifd
        if raw_ifd is None:
            raise DngError(f"{path}: no raster IFD found")

        if _TAG_TILE_WIDTH in raw_ifd:
            raise DngError(f"{path}: tiled DNG rasters are not supported "
                           "(convert with 'dnglab'/'Adobe DNG Converter' to "
                           "strip-based, or export uint16 .npy)")
        comp = raw_ifd.get(_TAG_COMPRESSION, 1)
        if comp != 1:
            raise DngError(
                f"{path}: compression {comp} not supported (only "
                "uncompressed strips); re-export as uncompressed DNG")

        w = raw_ifd[_TAG_WIDTH]
        h = raw_ifd[_TAG_LENGTH]
        bits = raw_ifd.get(_TAG_BITS, 16)
        if isinstance(bits, list):
            bits = bits[0]
        spp = raw_ifd.get(_TAG_SAMPLES_PER_PIXEL, 1)
        if spp != 1:
            raise DngError(f"{path}: {spp} samples/pixel (mosaic must be 1)")

        offsets = raw_ifd[_TAG_STRIP_OFFSETS]
        counts = raw_ifd.get(_TAG_STRIP_BYTE_COUNTS)
        offsets = offsets if isinstance(offsets, list) else [offsets]
        rows_per_strip = raw_ifd.get(_TAG_ROWS_PER_STRIP, h)
        # TIFF 6.0: every row begins on a byte boundary, so a bit-packed
        # row occupies ceil(w*bits/8) bytes regardless of alignment
        row_bytes = (w * bits + 7) // 8
        if counts is None:  # default per strip, not one count for the frame
            counts, left = [], h
            for _ in offsets:
                n = min(rows_per_strip, left)
                counts.append(n * row_bytes)
                left -= n
        counts = counts if isinstance(counts, list) else [counts]

        rows = []
        remaining = h
        for off, cnt in zip(offsets, counts):
            f.seek(off)
            buf = f.read(cnt)
            n_rows = min(rows_per_strip, remaining)
            n_vals = n_rows * w
            if bits == 16:
                arr = np.frombuffer(buf[: n_vals * 2],
                                    np.dtype(bo + "u2")).astype(np.uint16)
            elif bits == 8:
                arr = np.frombuffer(buf[:n_vals], np.uint8).astype(np.uint16)
            elif bits in (10, 12, 14):
                if (w * bits) % 8 == 0:
                    arr = _unpack_bits(buf, bits, n_vals)
                else:  # rows carry per-row byte padding — unpack each
                    arr = np.concatenate([
                        _unpack_bits(buf[r * row_bytes:(r + 1) * row_bytes],
                                     bits, w) for r in range(n_rows)])
            else:
                raise DngError(f"{path}: {bits}-bit samples not supported")
            rows.append(arr.reshape(n_rows, w))
            remaining -= n_rows
        mosaic = np.concatenate(rows, axis=0)

        cfa = None
        pat = raw_ifd.get(_TAG_CFA_PATTERN)
        if pat is not None:
            vals = pat if isinstance(pat, list) else [pat]
            cfa = "".join(_CFA_LETTER.get(v, "?") for v in vals)
        black = raw_ifd.get(_TAG_BLACK_LEVEL, 0)
        if isinstance(black, list):
            black = float(np.mean(black))
        white = raw_ifd.get(_TAG_WHITE_LEVEL, (1 << bits) - 1)
        if isinstance(white, list):
            white = float(white[0])
        neutral = raw_ifd.get(_TAG_AS_SHOT_NEUTRAL)
        meta = {"black_level": float(black), "white_level": float(white),
                "cfa": cfa, "bits": int(bits),
                "as_shot_neutral": neutral}
        return mosaic, meta


# ------------------------------------------------------------------ writer

def write_dng(path: str, mosaic: np.ndarray, *, black: int = 0,
              white: Optional[int] = None, cfa: str = "RGGB",
              bits: int = 16,
              as_shot_neutral: Optional[list] = None) -> None:
    """Minimal strip-based uncompressed DNG writer (fixtures / round-trip
    tests; layout follows the DNG 1.4 required tags for a CFA raw IFD)."""
    mosaic = np.asarray(mosaic)
    if mosaic.ndim != 2:
        raise DngError("mosaic must be (H, W)")
    h, w = mosaic.shape
    if white is None:
        white = (1 << bits) - 1

    if bits == 16:
        payload = mosaic.astype("<u2").tobytes()
    elif bits == 8:
        payload = mosaic.astype(np.uint8).tobytes()
    elif bits in (10, 12, 14):
        # TIFF 6.0: each ROW is padded to a byte boundary (a frame-wide
        # contiguous bit stream would shift rows whenever w*bits % 8 != 0)
        vals = mosaic.astype(np.uint16)
        stream = ((vals[:, :, None] >> np.arange(bits - 1, -1, -1)) & 1)
        stream = stream.astype(np.uint8).reshape(h, w * bits)
        pad = (-(w * bits)) % 8
        if pad:
            stream = np.concatenate(
                [stream, np.zeros((h, pad), np.uint8)], axis=1)
        payload = np.packbits(stream, axis=1).tobytes()
    else:
        raise DngError(f"{bits}-bit write not supported")

    entries = []  # (tag, type, count, packed_value_bytes_or_offset_marker)

    def short(tag, *vals):
        entries.append((tag, 3, len(vals),
                        struct.pack("<" + "H" * len(vals), *vals)))

    def long_(tag, *vals):
        entries.append((tag, 4, len(vals),
                        struct.pack("<" + "I" * len(vals), *vals)))

    def bytes_(tag, data):
        entries.append((tag, 1, len(data), bytes(data)))

    def rational(tag, vals):
        entries.append((tag, 5, len(vals), b"".join(
            struct.pack("<II", int(v * 10000), 10000) for v in vals)))

    bytes_(_TAG_DNG_VERSION, [1, 4, 0, 0])
    long_(_TAG_NEW_SUBFILE_TYPE, 0)
    long_(_TAG_WIDTH, w)
    long_(_TAG_LENGTH, h)
    short(_TAG_BITS, bits)
    short(_TAG_COMPRESSION, 1)
    short(_TAG_PHOTOMETRIC, _PHOTOMETRIC_CFA)
    short(_TAG_SAMPLES_PER_PIXEL, 1)
    long_(_TAG_ROWS_PER_STRIP, h)
    long_(_TAG_STRIP_BYTE_COUNTS, len(payload))
    short(_TAG_CFA_REPEAT_DIM, 2, 2)
    bytes_(_TAG_CFA_PATTERN, [_LETTER_CFA[c] for c in cfa])
    short(_TAG_BLACK_LEVEL, black)
    short(_TAG_WHITE_LEVEL, white)
    if as_shot_neutral:
        rational(_TAG_AS_SHOT_NEUTRAL, as_shot_neutral)
    long_(_TAG_STRIP_OFFSETS, 0)  # patched below
    entries.sort(key=lambda e: e[0])

    n = len(entries)
    ifd_off = 8
    data_off = ifd_off + 2 + n * 12 + 4  # overflow area starts here
    overflow = b""
    fields = b""
    strip_entry_payload_off = None
    for tag, ftype, count, packed in entries:
        size = len(packed)
        if size <= 4:
            val = packed + b"\0" * (4 - size)
        else:
            val = struct.pack("<I", data_off + len(overflow))
            overflow += packed
        if tag == _TAG_STRIP_OFFSETS:
            strip_entry_payload_off = ifd_off + 2 + len(fields) + 8
        fields += struct.pack("<HHI", tag, ftype, count) + val

    strip_off = data_off + len(overflow)
    ifd = struct.pack("<H", n) + fields + struct.pack("<I", 0)
    blob = bytearray(b"II*\0" + struct.pack("<I", ifd_off) + ifd
                     + overflow + payload)
    blob[strip_entry_payload_off:strip_entry_payload_off + 4] = \
        struct.pack("<I", strip_off)
    with open(path, "wb") as f:
        f.write(bytes(blob))


# ------------------------------------------------------------- postprocess

def postprocess(mosaic: np.ndarray, meta: dict) -> np.ndarray:
    """rawpy.postprocess stand-in: black-subtract -> bilinear demosaic ->
    white balance (AsShotNeutral if present, else gray-world) -> sRGB gamma
    -> uint8 BGR.  Used to fabricate GT sRGB from a long-exposure raw, the
    role rawpy plays at generate...SID_Sony.py:60-66."""
    cfa = meta.get("cfa") or "RGGB"
    if cfa != "RGGB":
        raise DngError(f"postprocess supports RGGB, got {cfa} "
                       "(crop to RGGB first, preprocessing.grbg_to_rggb)")
    x = (mosaic.astype(np.float32) - meta["black_level"]) / max(
        meta["white_level"] - meta["black_level"], 1.0)
    x = np.clip(x, 0.0, 1.0)
    h, w = x.shape
    # per-plane bilinear upsample of the 4 phases
    r = _upsample2(x[0::2, 0::2], h, w)
    g = 0.5 * (_upsample2(x[0::2, 1::2], h, w)
               + _upsample2(x[1::2, 0::2], h, w))
    b = _upsample2(x[1::2, 1::2], h, w)
    rgb = np.stack([r, g, b], axis=-1)
    neutral = meta.get("as_shot_neutral")
    if neutral and len(neutral) == 3 and all(v > 0 for v in neutral):
        gains = np.asarray([1.0 / v for v in neutral], np.float32)
    else:  # gray-world
        means = rgb.reshape(-1, 3).mean(axis=0) + 1e-6
        gains = means.mean() / means
    rgb = np.clip(rgb * gains[None, None, :], 0.0, 1.0)
    srgb = np.where(rgb <= 0.0031308, 12.92 * rgb,
                    1.055 * np.power(np.maximum(rgb, 1e-8), 1 / 2.4) - 0.055)
    bgr = (np.clip(srgb[..., ::-1], 0, 1) * 255.0 + 0.5).astype(np.uint8)
    return bgr


def _upsample2(plane: np.ndarray, h: int, w: int) -> np.ndarray:
    """2x bilinear upsample of a half-res CFA plane to (h, w)."""
    ph, pw = plane.shape
    yy = np.clip((np.arange(h) - 0.5) / 2.0, 0, ph - 1)
    xx = np.clip((np.arange(w) - 0.5) / 2.0, 0, pw - 1)
    y0 = np.floor(yy).astype(int)
    x0 = np.floor(xx).astype(int)
    y1 = np.minimum(y0 + 1, ph - 1)
    x1 = np.minimum(x0 + 1, pw - 1)
    fy = (yy - y0)[:, None]
    fx = (xx - x0)[None, :]
    tl = plane[np.ix_(y0, x0)]
    tr = plane[np.ix_(y0, x1)]
    bl = plane[np.ix_(y1, x0)]
    br = plane[np.ix_(y1, x1)]
    return ((1 - fy) * (1 - fx) * tl + (1 - fy) * fx * tr
            + fy * (1 - fx) * bl + fy * fx * br)


def main():  # pragma: no cover - thin CLI
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("dng")
    ap.add_argument("out_npy")
    ap.add_argument("--gt", help="also write a postprocessed sRGB .png here")
    args = ap.parse_args()
    mosaic, meta = read_dng(args.dng)
    np.save(args.out_npy, mosaic)
    print(f"{args.dng}: {mosaic.shape} {meta}")
    if args.gt:
        from reconfigisp_tpu_torch.utils import png
        png.write(args.gt, postprocess(mosaic, meta))


if __name__ == "__main__":  # pragma: no cover
    main()

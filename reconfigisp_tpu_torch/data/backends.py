"""Storage backends for training pairs: packed memmap, lmdb, file folders.

Counterpart of reconfigisp_tpu/data/backends.py, kept as its own copy (the
port imports nothing of the JAX package); host-side numpy only.  The
first-class backend is a packed record file: one flat binary blob plus a
pickle index, read through one numpy memmap (no per-record file opens,
page-cache friendly, sequential for prefetch).  lmdb databases are read when
the `lmdb` module imports.  Both packages write the same bytes and read
each other's files.

Layout produced by `PackedPairWriter` / consumed by `PackedReader`:
  <root>/pairs.pack     raw little-endian array bytes, 64-byte aligned
  <root>/meta_info.pkl  {"keys_noisy": [...], "keys_gt": [...],
                         "resolution": int, "records": {key: (offset,
                         shape, dtype_str)}}
The key lists mirror the reference's meta_info.pkl contract
(sid...dataset.py:33-38).
"""

from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np

from reconfigisp_tpu_torch.utils import png

PACK_FILE = "pairs.pack"
META_FILE = "meta_info.pkl"
_ALIGN = 64


class PackedPairWriter:
    """Append-only writer for the packed layout."""

    def __init__(self, root: str, resolution: Optional[int] = None):
        os.makedirs(root, exist_ok=True)
        self.root = root
        self.resolution = resolution
        self.records = {}
        self.keys_noisy = []
        self.keys_gt = []
        self._f = open(os.path.join(root, PACK_FILE), "wb")
        self._off = 0

    def _append(self, key: str, arr: np.ndarray) -> None:
        arr = np.ascontiguousarray(arr)
        pad = (-self._off) % _ALIGN
        if pad:
            self._f.write(b"\0" * pad)
            self._off += pad
        self.records[key] = (self._off, arr.shape, arr.dtype.str)
        data = arr.tobytes()
        self._f.write(data)
        self._off += len(data)

    def add_pair(self, key_noisy: str, noisy: np.ndarray,
                 key_gt: str, gt: np.ndarray) -> None:
        self._append(key_noisy, noisy)
        self._append(key_gt, gt)
        self.keys_noisy.append(key_noisy)
        self.keys_gt.append(key_gt)

    def close(self) -> None:
        self._f.close()
        meta = {
            "keys_noisy": self.keys_noisy,
            # alias matching the reference's "ratio" naming for SID dumps
            "keys_ratio": self.keys_noisy,
            "keys_gt": self.keys_gt,
            "resolution": self.resolution,
            "records": self.records,
        }
        with open(os.path.join(self.root, META_FILE), "wb") as f:
            pickle.dump(meta, f)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def load_meta(root: str) -> dict:
    with open(os.path.join(root, META_FILE), "rb") as f:
        return pickle.load(f)


class PackedReader:
    """Memmap-backed random access to a packed record file."""

    def __init__(self, root: str, meta: Optional[dict] = None):
        self.meta = meta or load_meta(root)
        self._mm = np.memmap(os.path.join(root, PACK_FILE), dtype=np.uint8,
                             mode="r")

    def read(self, key: str) -> np.ndarray:
        off, shape, dtype = self.meta["records"][key]
        dt = np.dtype(dtype)
        n = int(np.prod(shape)) * dt.itemsize
        return np.frombuffer(self._mm[off:off + n], dtype=dt).reshape(shape)


class LmdbReader:
    """Reference-compatible lmdb backend (keys -> raw array bytes with a
    shape/dtype sidecar in meta_info.pkl, or PNG buffers).  Gated
    on the lmdb module being importable."""

    def __init__(self, root: str, meta: Optional[dict] = None):
        try:
            import lmdb
        except ImportError as e:  # pragma: no cover - env without lmdb
            raise ImportError(
                "the 'lmdb' module is not available in this environment; "
                "use the packed backend (data/backends.py) instead") from e
        self.meta = meta or load_meta(root)
        self.env = lmdb.open(root, readonly=True, lock=False,
                             readahead=False, meminit=False)

    def read(self, key: str) -> np.ndarray:  # pragma: no cover - needs lmdb
        with self.env.begin(write=False) as txn:
            buf = txn.get(key.encode("ascii"))
        rec = self.meta.get("records", {}).get(key)
        if rec is not None:
            _, shape, dtype = rec
            return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)
        return png.decode(bytes(buf))


class FolderReader:
    """Plain file-per-record backend: key is a relative path under root
    (.npy, or PNG)."""

    def __init__(self, root: str, meta: Optional[dict] = None):
        self.root = root
        self.meta = meta

    def read(self, key: str) -> np.ndarray:
        path = os.path.join(self.root, key)
        if path.endswith(".npy"):
            return np.load(path)
        return png.read(path)


def open_backend(root: str, data_type: Optional[str] = None):
    """-> (reader, meta).  data_type: 'packed' | 'lmdb' | 'img' | None
    (auto: packed if pairs.pack exists, else lmdb if data.mdb exists, else
    folder)."""
    meta = None
    if os.path.exists(os.path.join(root, META_FILE)):
        meta = load_meta(root)
    if data_type is None:
        if os.path.exists(os.path.join(root, PACK_FILE)):
            data_type = "packed"
        elif os.path.exists(os.path.join(root, "data.mdb")):
            data_type = "lmdb"
        else:
            data_type = "img"
    reader = {"packed": PackedReader, "lmdb": LmdbReader,
              "img": FolderReader}[data_type](root, meta)
    return reader, (meta or getattr(reader, "meta", None))

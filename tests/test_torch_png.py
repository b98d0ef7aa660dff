"""The port's cv2-free image IO (reconfigisp_tpu_torch/utils/png.py, its row
filters in native/pngfilter.cpp) and area resize (utils/imaging.area_resize)
against cv2: PNG bytes built here with each row filter (0-4) and files cv2
wrote, read bit for bit as cv2.imread reads them; the writer's files read
back equal in cv2; INTER_AREA at the OnePlus geometry and at integer
ratios; and the data path (the OnePlus detection dataset, the folder
backend, raw-pair ingestion) with cv2 made unimportable, against the JAX
package's cv2 reads."""

import struct
import sys
import zlib

import cv2
import numpy as np
import pytest

from reconfigisp_tpu.data import datasets as jdatasets
from reconfigisp_tpu.data import preprocessing as jpre

from reconfigisp_tpu_torch.data import datasets
from reconfigisp_tpu_torch.data import preprocessing
from reconfigisp_tpu_torch.data.backends import FolderReader
from reconfigisp_tpu_torch.native import rawproc
from reconfigisp_tpu_torch.utils import png
from reconfigisp_tpu_torch.utils.imaging import area_resize
from torch_one_thread import one_thread  # noqa: F401  (autouse)

# (dtype, shape): uint16 grey (the OnePlus mosaics), uint8 BGR (the GTs and
# the test CLI's outputs), and the other two combinations
IMAGES = [(np.uint16, (23, 37)), (np.uint8, (19, 29, 3)),
          (np.uint8, (17, 21)), (np.uint16, (11, 13, 3))]
IMAGE_IDS = ["u16_grey", "u8_bgr", "u8_grey", "u16_bgr"]
AREA_TOL = 1e-6


def _image(dtype, shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, np.iinfo(dtype).max + 1, shape, dtype=dtype)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _png_bytes(img, ftype, bad_row=None):
    """`img` (uint8/16, grey or BGR) as PNG bytes whose every row carries
    filter `ftype`, filtered here in numpy from the PNG specification; row
    `bad_row` marked with the unknown filter type 9."""
    c = 1 if img.ndim == 2 else img.shape[2]
    rgb = img if c == 1 else img[..., ::-1]
    depth = 8 * img.dtype.itemsize
    rows = np.ascontiguousarray(rgb, ">u2" if depth == 16 else np.uint8)
    raw = rows.view(np.uint8).reshape(img.shape[0], -1).astype(np.int64)
    bpp = c * depth // 8
    left = np.zeros_like(raw)
    left[:, bpp:] = raw[:, :-bpp]
    up = np.zeros_like(raw)
    up[1:] = raw[:-1]
    upleft = np.zeros_like(raw)
    upleft[1:, bpp:] = raw[:-1, :-bpp]
    pred = {0: 0, 1: left, 2: up, 3: (left + up) // 2,
            4: _paeth(left, up, upleft)}[ftype]
    filtered = ((raw - pred) % 256).astype(np.uint8)
    types = np.full((raw.shape[0], 1), ftype, np.uint8)
    if bad_row is not None:
        types[bad_row] = 9
    data = np.concatenate([types, filtered], axis=1).tobytes()

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", img.shape[1], img.shape[0], depth,
                       0 if c == 1 else 2, 0, 0, 0)
    return (png.SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(data)) + chunk(b"IEND", b""))


def _cv2_decode(data: bytes):
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)


def _assert_same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4],
                         ids=["none", "sub", "up", "average", "paeth"])
@pytest.mark.parametrize("dtype,shape", IMAGES[:2], ids=IMAGE_IDS[:2])
def test_reader_undoes_each_filter_as_cv2(dtype, shape, ftype):
    img = _image(dtype, shape, seed=ftype)
    data = _png_bytes(img, ftype)
    want = _cv2_decode(data)
    _assert_same(want, img)
    _assert_same(png.decode(data), want)


@pytest.mark.parametrize("dtype,shape", IMAGES, ids=IMAGE_IDS)
def test_reader_matches_cv2_files(tmp_path, dtype, shape):
    """Files cv2 wrote, with its own choice of filters and compression."""
    img = _image(dtype, shape, seed=3)
    path = str(tmp_path / "x.png")
    assert cv2.imwrite(path, img)
    _assert_same(png.read(path), cv2.imread(path, cv2.IMREAD_UNCHANGED))


@pytest.mark.parametrize("dtype,shape", IMAGES, ids=IMAGE_IDS)
def test_writer_reads_back_in_cv2(tmp_path, dtype, shape):
    img = _image(dtype, shape, seed=4)
    path = str(tmp_path / "x.png")
    png.write(path, img)
    _assert_same(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)
    _assert_same(png.read(path), img)
    # a one-channel image is written as grey, as cv2 writes it
    if img.ndim == 2:
        png.write(path, img[..., None])
        _assert_same(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)


def test_reader_at_the_oneplus_frame_size(tmp_path):
    """A 3000x4000 10-bit mosaic as cv2 writes it (its adaptive filters),
    the size each OnePlus sample decodes."""
    img = _image(np.uint16, (3000, 4000), seed=5) % 1024
    path = str(tmp_path / "frame.png")
    assert cv2.imwrite(path, img)
    _assert_same(png.read(path), img)


@pytest.mark.parametrize("data,match", [
    (b"GIF89a" + bytes(16), "not a PNG"),
    ("palette", "only non-interlaced 8- or 16-bit"),
    ("bgra", "only non-interlaced 8- or 16-bit"),
    (b"bad filter", "unknown filter type"),
])
def test_reader_refuses_what_it_does_not_read(data, match):
    if data == "palette":    # the colour type byte of IHDR set to 3
        ok, buf = cv2.imencode(".png", _image(np.uint8, (4, 4), 1))
        raw = bytearray(buf.tobytes())
        raw[25] = 3
        data = bytes(raw)
    elif data == "bgra":
        ok, buf = cv2.imencode(".png", _image(np.uint8, (4, 4, 4), 1))
        data = buf.tobytes()
    elif data == b"bad filter":
        data = _png_bytes(_image(np.uint8, (4, 4)), 0, bad_row=1)
    with pytest.raises(ValueError, match=match):
        png.decode(data)


def test_unfilter_library_builds_into_the_build_directory():
    png.decode(_png_bytes(_image(np.uint8, (3, 3)), 4))
    lib = rawproc._library_path(png.SOURCE, rawproc.BUILD_DIR)
    assert lib.exists() and lib.name.startswith("pngfilter-")
    assert png._lib().pngfilter_version() == 1


@pytest.mark.parametrize("shape,size", [
    ((1500, 2000), (384, 512)),      # a OnePlus Bayer plane to 1024 wide
    ((3000, 4000, 3), (768, 1024)),  # a OnePlus scene's letterbox
    ((96, 128), (48, 64)),           # ratio 2
    ((90, 120), (30, 40)),           # ratio 3
    ((64, 96, 3), (16, 24)),         # ratio 4, three channels
    ((38, 50), (38, 50)),            # unchanged
], ids=["oneplus_plane", "oneplus_scene", "ratio2", "ratio3", "ratio4_bgr",
        "same"])
def test_area_resize_matches_inter_area(shape, size):
    img = np.random.default_rng(6).uniform(0, 1, shape).astype(np.float32)
    got = area_resize(img, size)
    want = cv2.resize(img, size[::-1], interpolation=cv2.INTER_AREA)
    assert got.shape == want.shape and got.dtype == np.float32
    assert float(np.abs(got - want).max()) <= AREA_TOL


def test_area_resize_shrinks_only():
    with pytest.raises(ValueError, match="shrinks only"):
        area_resize(np.zeros((8, 8), np.float32), (16, 8))


@pytest.fixture
def no_cv2(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)


def test_oneplus_dataset_without_cv2(tmp_path, monkeypatch):
    """The detection dataset's samples with cv2 made unimportable, against
    the JAX dataset's (cv2's read and INTER_AREA), bit for bit: train
    crops, eval tiles and whole frames, at a non-integer plane ratio."""
    from test_torch_yolo import _assert_samples_equal, _write_oneplus
    root = _write_oneplus(tmp_path / "oneplus")
    opts = [{"mode": "OnePlus_Rggb2Obj", "dataroot": root,
             "desired_size": 64, "max_crop": 3, "max_boxes": 4, "seed": 2,
             "data_size": size, "is_train": train}
            for size, train in ((32, True), (32, False), (None, False))]
    want = []
    for opt in opts:
        ds = jdatasets.create_dataset(opt)
        want.append([ds[i] for i in (0, 1, 0, len(ds) - 1)])
    monkeypatch.setitem(sys.modules, "cv2", None)
    for opt, samples in zip(opts, want):
        ds = datasets.create_dataset(opt)
        for i, w in zip((0, 1, 0, len(ds) - 1), samples):
            _assert_samples_equal(ds[i], w)


def test_folder_reads_without_cv2(tmp_path, no_cv2):
    """The pair folder's .png GT and the folder backend, cv2 unimportable;
    a file in another format raises with a clear message."""
    (tmp_path / "noisy").mkdir()
    (tmp_path / "gt").mkdir()
    gt = _image(np.uint8, (8, 12, 3), seed=7)
    np.save(tmp_path / "noisy" / "a.npy",
            np.random.default_rng(1).uniform(0, 1, (8, 12)).astype(
                np.float32))
    png.write(str(tmp_path / "gt" / "a.png"), gt)
    sample = datasets.RawPairFolderDataset(str(tmp_path))[0]
    np.testing.assert_array_equal(sample["gt"],
                                  gt.astype(np.float32) / 255.0)
    reader = FolderReader(str(tmp_path))
    _assert_same(reader.read("gt/a.png"), gt)
    (tmp_path / "gt" / "b.jpg").write_bytes(b"\xff\xd8\xff\xe0" + bytes(8))
    with pytest.raises(ValueError, match="PNG"):
        reader.read("gt/b.jpg")


def test_raw_pair_ingestion_of_png_gts_matches_jax(tmp_path, monkeypatch):
    """process_raw_pairs with PNG GTs: the JAX package reads them with cv2,
    the port with utils/png and cv2 unimportable; the records are equal."""
    rng = np.random.default_rng(8)
    raws, gts = [], []
    for i in range(2):
        raw = rng.integers(0, 1024, (16, 24), dtype=np.uint16)
        raws.append(str(tmp_path / f"r{i}.npy"))
        np.save(raws[-1], raw)
        gts.append(str(tmp_path / f"g{i}.png"))
        assert cv2.imwrite(gts[-1], _image(np.uint8, (16, 24, 3), seed=i))
    n_jax = jpre.process_raw_pairs(raws, gts, str(tmp_path / "jax"),
                                   black=0, white=1023, patch=None)
    monkeypatch.setitem(sys.modules, "cv2", None)
    n = preprocessing.process_raw_pairs(raws, gts, str(tmp_path / "port"),
                                        black=0, white=1023, patch=None)
    assert n == n_jax == 2
    for sub in ("noisy", "gt"):
        for name in ("r0", "r1"):
            np.testing.assert_array_equal(
                np.load(tmp_path / "port" / sub / f"{name}.npy"),
                np.load(tmp_path / "jax" / sub / f"{name}.npy"))

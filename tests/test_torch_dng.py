"""The port's raw ingestion (data/dng.py, data/preprocessing.py) against the
JAX package's: DNGs written by either package read by the other, the same
postprocessed ground truth, and byte-equal pair folders and packed records
from process_raw_pairs and synthesize_pair_folder on files written here."""

import filecmp
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from reconfigisp_tpu.data import dng as jdng
from reconfigisp_tpu.data import preprocessing as jpre

from reconfigisp_tpu_torch.data import RawPairFolderDataset, create_dataset
from reconfigisp_tpu_torch.data import dng, preprocessing

ROOT = Path(__file__).resolve().parents[1]


def _raw(shape, bits, seed=0):
    return np.random.default_rng(seed).integers(
        0, 1 << bits, shape).astype(np.uint16)


@pytest.mark.parametrize("bits,shape", [
    (16, (24, 32)), (8, (16, 20)), (10, (18, 26)), (12, (20, 30)),
    (14, (22, 34)), (14, (16, 17 * 2))],
    ids=["16", "8", "10", "12", "14", "14-odd-row-bytes"])
def test_dngs_cross_read_with_equal_mosaic_and_meta(tmp_path, bits, shape):
    """Each package reads the other's DNG: the same mosaic and metadata;
    and the two writers write the same bytes."""
    mosaic = _raw(shape, bits, seed=bits)
    kw = dict(black=1 << (bits - 4), cfa="RGGB", bits=bits,
              as_shot_neutral=[0.5, 1.0, 0.7])
    ours, theirs = tmp_path / "t.dng", tmp_path / "j.dng"
    dng.write_dng(str(ours), mosaic, **kw)
    jdng.write_dng(str(theirs), mosaic, **kw)
    assert ours.read_bytes() == theirs.read_bytes()
    for read, path in ((jdng.read_dng, ours), (dng.read_dng, theirs)):
        got, meta = read(str(path))
        np.testing.assert_array_equal(got, mosaic)
        assert meta == jdng.read_dng(str(theirs))[1]
        assert meta["bits"] == bits and meta["cfa"] == "RGGB"


@pytest.mark.parametrize("neutral", [[0.5, 1.0, 0.7], None],
                         ids=["as_shot_neutral", "gray_world"])
def test_postprocess_equals_jax(neutral):
    mosaic = _raw((32, 48), 14, seed=3)
    meta = {"black_level": 512.0, "white_level": 16383.0, "cfa": "RGGB",
            "bits": 14, "as_shot_neutral": neutral}
    got = dng.postprocess(mosaic, meta)
    assert got.dtype == np.uint8 and got.shape == (32, 48, 3)
    np.testing.assert_array_equal(got, jdng.postprocess(mosaic, meta))


def test_read_errors_match_jax(tmp_path):
    bad = tmp_path / "bad.dng"
    bad.write_bytes(b"not a tiff file")
    for read in (dng.read_dng, jdng.read_dng):
        with pytest.raises(ValueError, match="not a TIFF/DNG"):
            read(str(bad))
    with pytest.raises(dng.DngError, match="postprocess supports RGGB"):
        dng.postprocess(_raw((4, 4), 8), {"cfa": "GRBG"})


def _tree(root):
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*")
                  if p.is_file())


def _same_trees(a, b):
    assert _tree(a) == _tree(b) and _tree(a)
    for rel in _tree(a):
        assert filecmp.cmp(Path(a) / rel, Path(b) / rel, shallow=False), rel


def _inputs(tmp_path):
    """Two SID-like pairs: a 14-bit short-exposure DNG with a DNG ground
    truth (postprocessed), and a .npy raw with a .npy ground truth."""
    d = tmp_path / "in"
    d.mkdir()
    jdng.write_dng(str(d / "a_short.dng"), _raw((40, 56), 14, seed=5),
                   black=512, bits=14, as_shot_neutral=[0.6, 1.0, 0.8])
    jdng.write_dng(str(d / "a_long.dng"), _raw((40, 56), 14, seed=6),
                   black=512, bits=14)
    np.save(d / "b_short.npy", _raw((40, 56), 14, seed=7))
    np.save(d / "b_long.npy", np.random.default_rng(8).random(
        (40, 56, 3)).astype(np.float32))
    return ([str(d / "a_short.dng"), str(d / "b_short.npy")],
            [str(d / "a_long.dng"), str(d / "b_long.npy")])


@pytest.mark.parametrize("packed", [False, True], ids=["folders", "packed"])
def test_process_raw_pairs_writes_the_jax_packages_bytes(tmp_path, packed):
    """The same DNG and .npy inputs, per-pair ratios: byte-equal pair
    folders, or packed record and meta files, in both packages; the port's
    readers then load them."""
    raws, gts = _inputs(tmp_path)
    kw = dict(black=512, white=16383, ratio=[2.0, 1.5], patch=16, stride=12,
              packed=packed)
    n_t = preprocessing.process_raw_pairs(raws, gts, str(tmp_path / "t"),
                                          **kw)
    n_j = jpre.process_raw_pairs(raws, gts, str(tmp_path / "j"), **kw)
    assert n_t == n_j == 2 * 3 * 4
    _same_trees(tmp_path / "t", tmp_path / "j")
    if packed:
        ds = create_dataset({"mode": "SID", "dataroot":
                             str(tmp_path / "t"), "is_train": False})
    else:
        ds = RawPairFolderDataset(str(tmp_path / "t"))
    assert len(ds) == n_t
    sample = ds[0]
    assert sample["noisy"].shape == (16, 16, 1)
    assert sample["gt"].shape == (16, 16, 3)


def test_process_raw_pairs_whole_frames_from_dng_levels(tmp_path):
    """patch=None writes whole frames; black and white come from the DNG
    tags; a .npy raw without levels raises in both packages."""
    raws, gts = _inputs(tmp_path)
    for pre, out in ((preprocessing, "t"), (jpre, "j")):
        assert pre.process_raw_pairs(raws[:1], gts[:1], str(tmp_path / out),
                                     patch=None) == 1
        with pytest.raises(ValueError, match="black/white levels required"):
            pre.process_raw_pairs(raws[1:], gts[1:], str(tmp_path / out))
    _same_trees(tmp_path / "t", tmp_path / "j")


def test_synthesize_pair_folder_writes_the_jax_packages_bytes(tmp_path):
    assert preprocessing.synthesize_pair_folder(
        str(tmp_path / "t"), n=3, size=32, seed=4) == 3
    jpre.synthesize_pair_folder(str(tmp_path / "j"), n=3, size=32, seed=4)
    _same_trees(tmp_path / "t", tmp_path / "j")


def test_grbg_to_rggb():
    m = np.arange(16, dtype=np.float32).reshape(4, 4)
    out = preprocessing.grbg_to_rggb(m)
    np.testing.assert_array_equal(out, jpre.grbg_to_rggb(m))
    assert out.shape == (4, 2)


def test_dng_cli_writes_the_mosaic(tmp_path):
    mosaic = _raw((16, 24), 12, seed=9)
    jdng.write_dng(str(tmp_path / "a.dng"), mosaic, bits=12)
    res = subprocess.run(
        [sys.executable, "-m", "reconfigisp_tpu_torch.data.dng",
         str(tmp_path / "a.dng"), str(tmp_path / "a.npy")],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert res.returncode == 0, res.stdout + res.stderr
    np.testing.assert_array_equal(np.load(tmp_path / "a.npy"), mosaic)

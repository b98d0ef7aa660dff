"""The port's native rawproc library (native/rawproc.cpp, built with g++ at
first use) against its numpy forms and the JAX package's library, at the
tolerances of tests/test_native.py; and the rule that the new modules of
this slice import no JAX."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from reconfigisp_tpu.native import rawproc as jrawproc

from reconfigisp_tpu_torch.native import rawproc

ROOT = Path(__file__).resolve().parents[1]


def test_native_builds_into_the_build_directory():
    assert rawproc.HAVE_NATIVE
    lib = rawproc.library_path()
    assert lib.exists() and lib.parent == ROOT / "build" / "native"
    assert rawproc._lib().rawproc_version() == 1
    # a copy of the JAX package's source below its header comment
    ours, theirs = (
        (ROOT / pkg / "native" / "rawproc.cpp").read_text().split("#include", 1)
        for pkg in ("reconfigisp_tpu_torch", "reconfigisp_tpu"))
    assert ours[1] == theirs[1]


def test_failed_build_raises(tmp_path, monkeypatch):
    """No silent numpy fallback: a source that does not compile raises."""
    bad = tmp_path / "rawproc.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(rawproc, "SOURCE", bad)
    monkeypatch.setattr(rawproc, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(rawproc, "_loaded", [])
    with pytest.raises(RuntimeError, match="rawproc build failed"):
        rawproc.normalize_u16(np.zeros((2, 2), np.uint16), 0, 1)
    assert rawproc.HAVE_NATIVE is False


def test_normalize_semantics():
    raw = np.asarray([[512, 16383, 0]], np.uint16)
    out = rawproc.normalize_u16(raw, black=512, white=16383, ratio=1.0)
    np.testing.assert_allclose(out, [[0.0, 1.0, 0.0]], atol=1e-6)
    raw = np.asarray([[8448]], np.uint16)  # (8448-512)/15871 = 0.5
    out = rawproc.normalize_u16(raw, 512, 16383, ratio=3.0)
    np.testing.assert_allclose(out, [[1.0]], atol=1e-6)  # clipped


@pytest.mark.parametrize("ratio", [1.0, 2.5])
def test_normalize_equals_jax_and_numpy(ratio):
    raw = np.random.default_rng(1).integers(0, 16384, (64, 96)).astype(
        np.uint16)
    got = rawproc.normalize_u16(raw, 512, 16383, ratio)
    np.testing.assert_array_equal(got, jrawproc.normalize_u16(
        raw, 512, 16383, ratio))
    np.testing.assert_allclose(got, rawproc.normalize_u16_plain(
        raw, 512, 16383, ratio), atol=1e-6)


def test_crop_norm_batch_equals_jax_and_numpy():
    rng = np.random.default_rng(2)
    raws = rng.integers(0, 16384, (3, 40, 48)).astype(np.uint16)
    offs = rng.integers(-4, 44, (3, 2)).astype(np.int32) | 1  # odd: snapped
    got = rawproc.crop_norm_batch(raws, offs, 16, 512, 16383, 1.5)
    assert got.shape == (3, 16, 16)
    np.testing.assert_array_equal(got, jrawproc.crop_norm_batch(
        raws, offs, 16, 512, 16383, 1.5))
    np.testing.assert_allclose(got, rawproc.crop_norm_batch_plain(
        raws, offs, 16, 512, 16383, 1.5), atol=1e-6)


def test_pack_rggb_equals_jax_and_numpy():
    m = np.random.default_rng(3).random((12, 18)).astype(np.float32)
    got = rawproc.pack_rggb(m)
    np.testing.assert_array_equal(got, jrawproc.pack_rggb(m))
    np.testing.assert_array_equal(got, rawproc.pack_rggb_plain(m))
    m = np.arange(16, dtype=np.float32).reshape(4, 4)
    np.testing.assert_array_equal(rawproc.pack_rggb(m)[0], [[0, 2], [8, 10]])
    np.testing.assert_array_equal(rawproc.pack_rggb(m)[3], [[5, 7], [13, 15]])


def test_feather_accumulate_equals_jax_and_numpy():
    rng = np.random.default_rng(4)
    patches = rng.random((5, 8, 8, 3)).astype(np.float32)
    pos = np.asarray([[0, 0], [0, 6], [6, 0], [6, 6], [3, 4]], np.int32)
    mask = rng.uniform(0.1, 1.0, (8, 8)).astype(np.float32)
    out, count = rawproc.feather_accumulate(patches, pos, mask, 14, 14)
    for want_out, want_count in (
            jrawproc.feather_accumulate(patches, pos, mask, 14, 14),
            rawproc.feather_accumulate_plain(patches, pos, mask, 14, 14)):
        np.testing.assert_allclose(out, want_out, atol=1e-6)
        np.testing.assert_allclose(count, want_count, atol=1e-6)
    ones = np.ones((2, 4, 4, 3), np.float32)
    out, count = rawproc.feather_accumulate(
        ones, np.asarray([[0, 0], [2, 2]], np.int32), np.ones((4, 4),
                                                              np.float32), 8, 8)
    assert count[3, 3] == 2.0 and count[0, 0] == 1.0 and count[7, 7] == 0.0
    np.testing.assert_allclose(out[3, 3], [2, 2, 2])


def test_native_calls_refuse_operands_out_of_bounds():
    """The library would read or write past its buffers: the wrappers check
    first."""
    raws = np.zeros((2, 16, 16), np.uint16)
    with pytest.raises(ValueError, match="offsets"):
        rawproc.crop_norm_batch(raws, np.zeros((1, 2), np.int32), 8, 0, 1)
    with pytest.raises(ValueError, match="offsets"):
        rawproc.crop_norm_batch(raws, np.zeros((2, 2), np.int32), 32, 0, 1)
    patches = np.ones((2, 4, 4, 3), np.float32)
    mask = np.ones((4, 4), np.float32)
    for pos in ([[0, 0], [5, 0]], [[0, 0], [0, -1]], [[0, 0]]):
        with pytest.raises(ValueError, match="must lie inside"):
            rawproc.feather_accumulate(patches, np.asarray(pos, np.int32),
                                       mask, 8, 8)
    with pytest.raises(ValueError, match="must lie inside"):
        rawproc.feather_accumulate(patches, np.zeros((2, 2), np.int32),
                                   mask[:3], 8, 8)


def test_new_modules_import_no_jax():
    code = ("import sys\n"
            "import reconfigisp_tpu_torch.deploy, reconfigisp_tpu_torch.export\n"
            "import reconfigisp_tpu_torch.native.rawproc\n"
            "import reconfigisp_tpu_torch.data.dng\n"
            "import reconfigisp_tpu_torch.data.preprocessing\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'reconfigisp_tpu')]\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert res.returncode == 0, res.stdout + res.stderr

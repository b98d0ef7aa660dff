"""The port's data layer against the JAX package's, on the CPU.

Datasets, samplers, loaders and the packed record backend are numpy in both
packages, so samples, index streams and batches must be equal bit for bit,
and record files byte for byte.  The one exception is the planted GT, which
each package computes with its own Malvar, wb_manual and gamma: within
1e-4, the tolerance of the zoo tests (tests/test_torch_ops.py).
"""

import json
import os

import numpy as np
import pytest

from reconfigisp_tpu.data import backends as jbackends
from reconfigisp_tpu.data import datasets as jdatasets
from reconfigisp_tpu.data import sampler as jsampler

from reconfigisp_tpu_torch.data import backends, datasets, sampler
from reconfigisp_tpu_torch.utils import imaging

PLANTED_GT_TOL = 1e-4


def _assert_sample_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _write_records(root, writer_cls, n=4, h=40, w=56, seed=0, expo=True):
    """n pairs of uint16 14-bit raws and uint8 BGR GTs from `seed`."""
    rng = np.random.default_rng(seed)
    with writer_cls(str(root), resolution=h) as wr:
        for i in range(n):
            raw = rng.integers(0, 16384, (h, w), dtype=np.uint16)
            gt = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            tag = ("0.1s", "10s") if expo and i % 2 == 0 else ("0.04s", "10s")
            wr.add_pair(f"noisy_{i}_{tag[0]}", raw, f"gt_{i}_{tag[1]}", gt)
    return root


def _write_folder(root, n=3, h=36, w=44, seed=1):
    rng = np.random.default_rng(seed)
    os.makedirs(root / "noisy")
    os.makedirs(root / "gt")
    for i in range(n):
        np.save(root / "noisy" / f"f{i}.npy",
                rng.integers(0, 1024, (h, w), dtype=np.uint16))
        np.save(root / "gt" / f"f{i}.npy",
                rng.uniform(0, 1, (h, w, 3)).astype(np.float32))
    return root


# ----------------------------------------------------------------- backends

def test_packed_writer_bytes_identical(tmp_path):
    """Both writers give the same pairs.pack and meta_info.pkl, byte for
    byte, and each reader reads the other's records."""
    _write_records(tmp_path / "jax", jbackends.PackedPairWriter)
    _write_records(tmp_path / "port", backends.PackedPairWriter)
    for f in (backends.PACK_FILE, backends.META_FILE):
        assert (tmp_path / "jax" / f).read_bytes() == \
            (tmp_path / "port" / f).read_bytes(), f
    meta = backends.load_meta(str(tmp_path / "jax"))
    assert meta == jbackends.load_meta(str(tmp_path / "port"))
    port_reads_jax = backends.PackedReader(str(tmp_path / "jax"))
    jax_reads_port = jbackends.PackedReader(str(tmp_path / "port"))
    for key in meta["records"]:
        a, b = port_reads_jax.read(key), jax_reads_port.read(key)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_open_backend_kinds(tmp_path):
    """packed and file-folder backends are found as in JAX; lmdb is gated
    on its module in both."""
    _write_records(tmp_path / "packed", backends.PackedPairWriter)
    reader, meta = backends.open_backend(str(tmp_path / "packed"))
    jreader, jmeta = jbackends.open_backend(str(tmp_path / "packed"))
    assert type(reader).__name__ == type(jreader).__name__ == "PackedReader"
    assert meta == jmeta
    folder = tmp_path / "folder"
    folder.mkdir()
    np.save(folder / "a.npy", np.arange(6, dtype=np.float32))
    reader, meta = backends.open_backend(str(folder))
    assert isinstance(reader, backends.FolderReader) and meta is None
    np.testing.assert_array_equal(reader.read("a.npy"),
                                  np.arange(6, dtype=np.float32))
    try:
        import lmdb  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError):
            backends.LmdbReader(str(tmp_path / "packed"))
        with pytest.raises(ImportError):
            jbackends.LmdbReader(str(tmp_path / "packed"))


# ----------------------------------------------------------------- datasets

@pytest.mark.parametrize("kw", [{}, {"global_prob": 0.5},
                                {"noise_std": 0.07, "gain": 1.0, "seed": 3}],
                         ids=["plain", "global", "seeded"])
def test_synthetic_samples_bit_identical(kw):
    a = datasets.SyntheticRawDataset(n=8, size=24, **kw)
    b = jdatasets.SyntheticRawDataset(n=8, size=24, **kw)
    for idx in (0, 3, 7):
        _assert_sample_equal(a[idx], b[idx])
        _assert_sample_equal(a[idx], b[idx])   # repeated access


def test_planted_samples_match():
    """The noisy mosaic bit for bit; the planted GT (each package's own
    ops) within PLANTED_GT_TOL; repeated accesses from the cache."""
    a = datasets.SyntheticPlantedDataset(n=4, size=16, seed=2)
    b = jdatasets.SyntheticPlantedDataset(n=4, size=16, seed=2)
    assert a.WB_PARAMS01 == b.WB_PARAMS01
    assert a.GAMMA_PARAM01 == b.GAMMA_PARAM01
    for idx in (0, 3, 0):
        sa, sb = a[idx], b[idx]
        np.testing.assert_array_equal(sa["noisy"], sb["noisy"])
        assert sa["gt"].dtype == sb["gt"].dtype == np.float32
        np.testing.assert_allclose(sa["gt"], sb["gt"], rtol=0,
                                   atol=PLANTED_GT_TOL)
        assert float(np.abs(sa["gt"] - sa["noisy"]).max()) > 0.05


@pytest.mark.parametrize("is_train", [True, False], ids=["train", "eval"])
def test_record_dataset_crops_bit_identical(tmp_path, is_train):
    """SID records: train crops drawn afresh at each access (the same k-th
    crop in both), eval whole frames; from the access base on, too."""
    root = str(_write_records(tmp_path, backends.PackedPairWriter))
    kw = dict(data_size=16, white_level=16383.0, seed=5, is_train=is_train)
    a = datasets.PairRecordDataset(root, **kw)
    b = jdatasets.PairRecordDataset(root, **kw)
    seen = []
    for idx in (1, 1, 2, 1, 0):
        sa, sb = a[idx], b[idx]
        _assert_sample_equal(sa, sb)
        seen.append(sa["noisy"])
    if is_train:
        assert seen[0].shape == (16, 16, 1)
        assert not np.array_equal(seen[0], seen[1])   # a fresh crop
    else:
        assert seen[0].shape == (40, 56, 1)
    datasets.set_access_base(a, 7)
    jdatasets.set_access_base(b, 7)
    _assert_sample_equal(a[3], b[3])


def test_record_dataset_exposure_filter(tmp_path):
    root = str(_write_records(tmp_path, backends.PackedPairWriter))
    a = datasets.PairRecordDataset(root, expo_in="0.1s", expo_gt="10s",
                                   is_train=False)
    b = jdatasets.PairRecordDataset(root, expo_in="0.1s", expo_gt="10s",
                                    is_train=False)
    assert a.keys_noisy == b.keys_noisy == ["noisy_0_0.1s", "noisy_2_0.1s"]
    _assert_sample_equal(a[1], b[1])


@pytest.mark.parametrize("data_size,is_train", [(16, True), (16, False),
                                                (None, True)])
def test_folder_dataset_bit_identical(tmp_path, data_size, is_train):
    root = str(_write_folder(tmp_path))
    kw = dict(data_size=data_size, seed=4, is_train=is_train)
    a = datasets.RawPairFolderDataset(root, **kw)
    b = jdatasets.RawPairFolderDataset(root, **kw)
    assert a.names == b.names
    for idx in (0, 2, 0, 0):
        _assert_sample_equal(a[idx], b[idx])


def test_create_dataset_modes(tmp_path):
    """The factory picks the same class with the same settings, the
    detection modes too; OnePlus on a folder without frames raises in
    both."""
    root = str(_write_records(tmp_path / "rec", backends.PackedPairWriter))
    folder = str(_write_folder(tmp_path / "folder"))
    for opt in ({"mode": "synthetic", "n": 6, "data_size": 16, "seed": 2},
                {"mode": "synthetic_planted", "n": 3, "data_size": 16},
                {"mode": "SID_Records", "dataroot": root, "data_size": 16,
                 "sid_expo_in": "0.04s"},
                {"mode": "S7ISP_Folder", "dataroot": folder,
                 "data_size": 8, "is_train": None}):
        a, b = datasets.create_dataset(opt), jdatasets.create_dataset(opt)
        assert type(a).__name__ == type(b).__name__
        assert len(a) == len(b)
        sa, sb = a[len(a) - 1], b[len(b) - 1]
        np.testing.assert_array_equal(sa["noisy"], sb["noisy"])
        np.testing.assert_allclose(sa["gt"], sb["gt"], rtol=0,
                                   atol=PLANTED_GT_TOL)
    opt = {"mode": "synthetic_yolo", "n": 3, "data_size": 16, "seed": 2}
    a, b = datasets.create_dataset(opt), jdatasets.create_dataset(opt)
    assert type(a).__name__ == type(b).__name__ == "SyntheticDetectionDataset"
    for k in ("noisy", "gt", "label"):
        np.testing.assert_array_equal(a[2][k], b[2][k])
    for factory in (datasets.create_dataset, jdatasets.create_dataset):
        with pytest.raises(ValueError, match="matching"):
            factory({"mode": "OnePlus_Records", "dataroot": folder})
    with pytest.raises(ValueError, match="unknown dataset mode"):
        datasets.create_dataset({"mode": "nope"})


# ---------------------------------------------------------- samplers, loaders

def _take(it, n):
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("skip", [0, 5, 27])
def test_create_loader_streams_and_batches(skip):
    """create_loader's index stream (across epochs, after `skip`) and its
    prefetched batches."""
    ds = datasets.SyntheticRawDataset(n=10, size=16)
    jds = jdatasets.SyntheticRawDataset(n=10, size=16)
    a = sampler.create_loader(ds, 3, shuffle_seed=4, skip=skip)
    b = jsampler.create_loader(jds, 3, shuffle_seed=4, skip=skip)
    assert a.sampler.per_epoch_len == b.sampler.per_epoch_len == 10
    assert _take(iter(a.sampler), 35) == _take(iter(b.sampler), 35)
    for ba, bb in zip(_take(iter(a), 4), _take(iter(b), 4)):
        _assert_sample_equal(ba, bb)


@pytest.mark.parametrize("start_epoch", [0, 2])
def test_search_loaders_streams_and_batches(tmp_path, start_epoch):
    """The half-split samplers (train half, val half), from a start epoch,
    and batches of a record dataset with fresh crops: the train and val
    threads draw disjoint images, so per-image counters keep the crops
    deterministic."""
    root = str(_write_records(tmp_path, backends.PackedPairWriter, n=6))
    ds = datasets.PairRecordDataset(root, data_size=16, seed=1)
    jds = jdatasets.PairRecordDataset(root, data_size=16, seed=1)
    (ta, va) = sampler.create_search_loaders(ds, 2, seed=3,
                                             start_epoch=start_epoch)
    (tb, vb) = jsampler.create_search_loaders(jds, 2, seed=3,
                                              start_epoch=start_epoch)
    for la, lb in ((ta, tb), (va, vb)):
        assert la.sampler.per_epoch_len == lb.sampler.per_epoch_len
        assert _take(iter(la.sampler), 400) == _take(iter(lb.sampler), 400)
    got = [(x, y) for x, y in zip(_take(iter(ta), 3), _take(iter(va), 3))]
    want = [(x, y) for x, y in zip(_take(iter(tb), 3), _take(iter(vb), 3))]
    for (xa, ya), (xb, yb) in zip(got, want):
        _assert_sample_equal(xa, xb)
        _assert_sample_equal(ya, yb)


def test_half_split_sampler_ranks():
    for half in ("train", "val"):
        for rank in (0, 1, 2):
            a = sampler.HalfSplitSampler(9, half, rank=rank, world=3,
                                         enlarge=4, seed=6)
            b = jsampler.HalfSplitSampler(9, half, rank=rank, world=3,
                                          enlarge=4, seed=6)
            assert a.per_epoch_len == b.per_epoch_len
            np.testing.assert_array_equal(a.epoch_indices(2),
                                          b.epoch_indices(2))
    with pytest.raises(ValueError):
        sampler.HalfSplitSampler(1, "train")


# ------------------------------------------------------------------ imaging

def test_imaging_helpers(tmp_path):
    from reconfigisp_tpu.utils import imaging as jimaging
    rng = np.random.default_rng(8)
    t = rng.uniform(-0.1, 1.1, (2, 5, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(imaging.tensor2bgr(t),
                                  jimaging.tensor2bgr(t))
    state = rng.integers(0, 1024, (4, 4), dtype=np.uint16)
    np.testing.assert_array_equal(imaging.state2tensor(state),
                                  jimaging.state2tensor(state))
    np.testing.assert_array_equal(imaging.tensor2state(t[0, ..., 0]),
                                  jimaging.tensor2state(t[0, ..., 0]))
    exp = tmp_path / "exp"
    exp.mkdir()
    (exp / "keep.txt").write_text("x")
    imaging.mkdir_and_rename(str(exp))
    assert exp.is_dir() and not any(exp.iterdir())
    assert len([p for p in tmp_path.iterdir()
                if p.name.startswith("exp_archived_")]) == 1


def test_metrics_logger_writes_json_lines(tmp_path):
    from reconfigisp_tpu_torch.utils.logging_utils import (
        MetricsLogger, setup_logger)
    m = MetricsLogger(str(tmp_path))
    m.scalars(3, {"loss": np.float32(0.5), "val": 2})
    m.close()
    rec = json.loads((tmp_path / "metrics.jsonl").read_text())
    assert rec["step"] == 3 and rec["loss"] == 0.5 and rec["val"] == 2.0
    logger = setup_logger("torch_data_test", str(tmp_path), "t",
                          screen=False)
    logger.info("hello")
    assert "hello" in (tmp_path / "t.log").read_text()

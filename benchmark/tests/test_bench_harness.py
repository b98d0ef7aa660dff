"""The harness finds every cell, mix, limit and metric by name; a cell is
added by new files alone; the counts give the hand figures; the trace
reduction counts overlapping kernels once.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import hashlib
import json
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import run  # noqa: E402
from benchmark.lib import counts, roofline, spec  # noqa: E402
from benchmark.lib.trace import Trace, group  # noqa: E402
from benchmark.tests.tiny import tiny_root  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_finds_its_files_by_name(cell):
    c = spec.load(cell)
    assert hasattr(c.system(), "System")
    assert hasattr(c.generator(), "make")
    assert c.limits["limits"]
    e2e = [m["name"] for m in c.end_to_end()]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer()
    for m in c.end_to_end() + c.per_layer():
        assert callable(c.reader(m["name"]).read)
    for m in c.per_layer():
        assert m["moves"] in e2e


def _digests(root: Path) -> dict:
    return {p.relative_to(root).as_posix():
            hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "benchmark").rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_throwaway_cell_is_new_files_and_entries(tmp_path):
    tiny_root(tmp_path)
    before, after = _digests(ROOT), _digests(tmp_path)
    changed = [p for p in before if after.get(p) != before[p]]
    assert changed == []
    added = sorted(set(after) - set(before))
    assert added == sorted(
        f"benchmark/{kind}/{name}.json" for kind, name in (
            ("configs", "tiny_isp"), ("configs", "tiny_search"),
            ("traffic", "tiny_frames"), ("traffic", "tiny_crops"),
            ("limits", "tiny_serve"), ("limits", "tiny_search")))
    new = json.loads((tmp_path / "BENCHMARK.json").read_text())
    for key in ("configs", "workloads"):
        assert new[key][:len(BENCH[key])] == BENCH[key]
    cell = spec.load("tiny_serve", root=tmp_path)
    result = run.execute(cell, 2 ** 40 + 7, 0.3, False, "cpu")
    assert result["correct"] is True
    assert set(result["metrics"]) == {"serve_mp_per_s", "serve_frame_ms_p95",
                                      "setup_s"}
    assert list(result)[-1] == "checks"


def test_serving_counts_match_the_hand_figures():
    # Path-Restore-14L: 2 x 9 x 64 x (4 + 12 x 64 + 4) per packed position,
    # 256^2 positions a 512^2 tile, 54 tiles a 2848 x 4256 frame
    per_pos = 2 * 9 * 64 * (4 + 12 * 64 + 4)
    cnn = per_pos * 256 * 256 * 54
    assert cnn == pytest.approx(3.164e12, rel=1e-3)
    assert counts.frame_tiles(2848, 4256, 512, 480) == 54
    total = counts.serve_frame_flops("Bayer_01_Demosaic_03_sRGB_01_13_11",
                                     2848, 4256, 512, 480)
    assert cnn < total < cnn * 1.001


def test_kernel_bounds_match_the_hand_figures():
    # (8, 512, 512, 3) at radius 4 (and fast NLM block 4): bilateral and
    # fast NLM 40 exps a value on the SFUs, median 50.3 MB at 3.35 TB/s
    shape = (8, 512, 512, 3)
    assert counts.kernel_bound_s("bilateral", shape, 4) * 1e3 == \
        pytest.approx(0.06018, abs=5e-6)
    assert counts.kernel_bound_s("median", shape, 4) * 1e3 == \
        pytest.approx(0.01502, abs=5e-6)
    assert counts.kernel_bound_s("fastnlm", shape, 4, 4) * 1e3 == \
        pytest.approx(0.06018, abs=5e-6)


RADII = {f"step{k}": {"bilateral": (4, 0), "median": (4, 0),
                      "fastnlm": (4, 4)} for k in (1, 2, 3)}


def test_a_native_step_needs_fifteen_applications_of_each_windowed_op():
    # five passes, each applying each of the three sRGB slots' candidates
    need = counts.search_step_windowed(3, False, 4, 48, RADII)
    assert {op: len(v) for op, v in need.items()} == {
        "bilateral": 15, "median": 15, "fastnlm": 15}
    assert {a for v in need.values() for a in v} >= {
        ((4, 48, 48, 3), 4, 0), ((4, 48, 48, 3), 4, 4)}
    assert counts.search_step_windowed(3, True, 4, 48, RADII) == {}


class _Run:
    def __init__(self, kernels):
        self.trace = Trace(kernels, [], (0, 10 ** 6))
        self.work = {"windowed": counts.search_step_windowed(
            3, False, 4, 48, RADII)}
        self.record = {"profiled": [False, True, False]}


def test_a_roofline_does_not_move_when_launches_are_grouped():
    # the same 150 us of device time in 15 launches or in 5 larger ones
    apart = _Run([("void bilateral_kernel<3, 0>", 20 * i, 20 * i + 10)
                  for i in range(15)])
    grouped = _Run([("void bilateral_kernel<3, 0>", 40 * i, 40 * i + 30)
                    for i in range(5)])
    bound = 15 * counts.kernel_bound_s("bilateral", (4, 48, 48, 3), 4)
    assert roofline.share(apart, "bilateral") == pytest.approx(
        100 * bound / 150e-6)
    assert roofline.share(grouped, "bilateral") == pytest.approx(
        roofline.share(apart, "bilateral"))
    assert roofline.share(apart, "median") is None


def test_trace_reduction_counts_overlap_once_and_names_gaps():
    kernels = [("void cudnn::conv_kernel", 0, 10),
               ("void at::elementwise_kernel", 5, 20),
               ("void bilateral_kernel<3, 4>", 30, 40)]
    host = [("Buffer Flush", 22, 27), ("aten::add", 20, 30)]
    t = Trace(kernels, host, (0, 50))
    assert t.busy() == [[0, 20], [30, 40]]
    assert t.busy_s == pytest.approx(30e-6)
    assert t.gaps() == [(20, 30), (40, 50)]
    assert t.instrument_idle_s() == pytest.approx(5e-6)
    assert t.idle_share() == pytest.approx(15 / 45)
    b = t.breakdown()
    assert b["idle_gaps"][0][0] in ("Buffer Flush", "no host op")
    assert [g for g, _ in b["device_ops"]] == ["elementwise", "convolution",
                                               "bilateral kernel"]
    assert group("void nhwcToNchwKernel") == "layout"

"""Serving the flagship pipeline with median and fast-NLM after demosaic
(Bayer_01_Demosaic_03_sRGB_08_09_01_13_11, the benchmark's sid_isp_denoise
configuration): the port's make_serving_fn against the benchmark's plain
reference (benchmark/reference/serve.serve_frame), on the CPU with the
windowed ops' plain forms and, marked `cuda`, on the card with the hand
kernels; and the serving system's count of the windowed work.

Weights, logits and mosaics are drawn from a seed by the benchmark's own
set-up (benchmark/systems/serve_denoise.System, benchmark/lib/weights), at
a frame size whose tiles overlap and whose last row and column of tiles
are flush with its edges.

    python -m pytest -q tests/test_torch_serve_denoise.py
    python -m pytest -q -m cuda tests/test_torch_serve_denoise.py  # card
"""

from __future__ import annotations

import json
import types
from pathlib import Path

import pytest
import torch

from benchmark.generators import mosaics
from benchmark.lib import counts
from benchmark.lib.device import tf32
from benchmark.reference import serve as refserve
from benchmark.systems import serve_denoise
from reconfigisp_tpu_torch.ops.kernels import fastnlm, median

from torch_one_thread import one_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
CONFIG = json.loads((BENCH / "configs" / "sid_isp_denoise.json").read_text())
FRAMES = json.loads((BENCH / "traffic" / "sid_frames.json").read_text())
LIMITS = json.loads((BENCH / "limits" / "sid_serve_denoise_f32.json")
                    .read_text())["limits"]
ARCH = "Bayer_01_Demosaic_03_sRGB_08_09_01_13_11"
FLAGSHIP = "Bayer_01_Demosaic_03_sRGB_01_13_11"

# The CPU comparison's tolerance.  Both sides take the median's exact
# middle tap, and both plain fast-NLMs sum the same terms in the same
# order; what differs is the order of a few products (the fast-NLM's decay,
# the blend) and Path-Restore's convolution algorithms, float32 roundings
# of values near 1 that read 2.4e-7 at most over four seeds.  1e-5 leaves
# forty times that, where a wrong tap, radius or tile blend moves the
# output by 1e-3 or more (leaving both ops out moves it by more than that
# here).
CPU_ATOL = 1e-5


def _system(height: int, width: int, patch: int, stride: int, seed: int,
            device) -> serve_denoise.System:
    """The benchmark's serving system of sid_isp_denoise at a frame of
    height x width tiled patch / stride, one frame in its pool, set up."""
    cfg = dict(CONFIG, patch=patch, stride=stride)
    traffic = dict(FRAMES, frames=1, height=height, width=width,
                   checked_frames=1, profile_frames=1)
    cell = types.SimpleNamespace(config=cfg, traffic=traffic,
                                 generator=lambda: mosaics)
    system = serve_denoise.System(cell, seed, device)
    with system.context():
        system.setup()
    return system


def _served_and_reference(system):
    with system.context():
        got = system.serve(system.pool[0])
        want = refserve.serve_frame(
            ARCH, system.pool[0], system.weights, system.logits,
            patch=system.cfg["patch"], stride=system.cfg["stride"])
    return got, want


def test_config_is_the_denoise_pipeline():
    assert CONFIG["architecture"] == ARCH
    assert CONFIG["system"] == "serve_denoise"
    assert (CONFIG["patch"], CONFIG["stride"]) == (512, 480)
    assert CONFIG["cnn_storage"] == "f32" and CONFIG["tf32"] is False


@pytest.fixture(scope="module")
def small():
    """1 x 96 x 128 tiled 64 / 48: tile origins 0, 32 by 0, 48, 64."""
    return _system(96, 128, 64, 48, 2 ** 33 + 5, torch.device("cpu"))


def test_served_frame_matches_the_reference_on_the_cpu(small):
    got, want = _served_and_reference(small)
    assert got.shape == want.shape == (1, 96, 128, 3)
    gap = float((got - want).abs().max())
    assert gap <= CPU_ATOL, gap
    # the windowed ops do work here: the frame differs from the flagship's
    # (the same steps and logits without median and fast-NLM)
    logits = {i - 2 if i > 3 else i: v for i, v in small.logits.items()
              if i not in (2, 3)}
    flagship = refserve.serve_frame(
        FLAGSHIP, small.pool[0], small.weights, logits, patch=64, stride=48)
    assert float((got - flagship).abs().max()) > 1e-3


def test_work_counts_the_windowed_ops_per_tile(small):
    radii = small.radii()
    assert radii == {"median": (4, 0), "fastnlm": (4, 4)}
    work = small.work()
    tiles = counts.frame_tiles(96, 128, 64, 48)
    assert tiles == 6
    assert work["windowed"] == {
        "median": [((1, 64, 64, 3), 4, 0)] * tiles,
        "fastnlm": [((1, 64, 64, 3), 4, 4)] * tiles}
    assert work["flops_per_frame"] == counts.serve_frame_flops(
        ARCH, 96, 128, 64, 48, radii)
    assert work["peak_flops"] == counts.PEAK_FLOPS["f32"]
    with pytest.raises(KeyError):   # what the flagship's count cannot do
        counts.serve_frame_flops(ARCH, 96, 128, 64, 48)


def test_window_opens_with_the_launch_counters_at_zero(small):
    before = median.launches, fastnlm.launches
    try:
        median.launches, fastnlm.launches = 5, 7
        with small.context():
            record = small.window(0.05, False)
        # the CPU runs the plain forms, which count no launch
        assert record["launches"] == {"median": 0, "fastnlm": 0}
        assert record["frames"] >= 1
    finally:
        median.launches, fastnlm.launches = before


@pytest.mark.cuda
def test_served_frame_on_the_card_is_within_the_cell_limits():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    with tf32(False):
        system = _system(1024, 1536, 512, 480, 2 ** 32 + 9,
                         torch.device("cuda"))
        launches = median.launches, fastnlm.launches
        got, want = _served_and_reference(system)
        # 12 tiles, one group of the serving function's 32: one launch each
        assert (median.launches - launches[0],
                fastnlm.launches - launches[1]) == (1, 1)
    gaps = system.compare([(0, got)], [(0, want)])
    for name, limit in LIMITS.items():
        assert gaps[name] <= limit, (name, gaps[name], limit)

"""The port's spans on the card: a DARTS step captured as a CUDA graph
carries its device spans as timing events, read for the last replay that
no profiler recorded; each captured span lies within its parent; the
graph's counters count only the replays no profiler recorded, after the
first; a served frame's device spans read the card.

Needs an NVIDIA GPU; every test skips without a card.  The file imports no
JAX, so on a machine without JAX it runs alone:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_tracing_cuda.py
"""

import numpy as np
import pytest
import torch

import reconfigisp_tpu_torch as rt
from reconfigisp_tpu_torch import deploy
from reconfigisp_tpu_torch.search import DartsTrainer
from reconfigisp_tpu_torch.supernet import SuperNet
from reconfigisp_tpu_torch.utils import tracing

pytestmark = pytest.mark.cuda

PASSES = ("darts.virtual", "darts.unrolled", "darts.hessian_pos",
          "darts.hessian_neg", "darts.update")
BACKWARD = ("bilateral.backward", "median.backward", "fastnlm.backward")
TRAIN_OPT = {"lr_G": 1e-2, "momentum_G": 0.9, "lr_meta": 1e-2, "beta1": 0.9,
             "beta2": 0.99, "pixel_criterion": "l2"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    tracing.reset()
    yield torch.device("cuda")
    tracing.reset()


def _pairs(n):
    rng = np.random.default_rng(36)
    mk = lambda c: rng.uniform(0.05, 0.95, (2, 32, 32, c)).astype(np.float32)
    return [({"noisy": mk(1), "gt": mk(3)}, {"noisy": mk(1), "gt": mk(3)})
            for _ in range(n)]


@pytest.fixture
def trainer(cuda):
    """A trainer whose step is captured, after two unprofiled steps and one
    under the profiler: the first replay uploads the graph."""
    tr = DartsTrainer(SuperNet(1, 0.2, srgb_count=9, device=cuda),
                      dict(TRAIN_OPT))
    pairs = _pairs(3)
    tr.search_step(*pairs[0])
    tr.search_step(*pairs[1])
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        tr.search_step(*pairs[2])
    torch.cuda.synchronize()
    return tr


def test_a_captured_step_times_every_pass_on_each_replay(trainer):
    graph = trainer.graph
    got = graph.device_spans()
    names = [n for n, _, _ in got]
    assert names[0] == "darts.step" and got[0][1] is None
    assert [n for n, p, _ in got if p == 0] == list(PASSES)
    assert set(BACKWARD) <= set(names)
    assert all(names[p] in PASSES for n, p, _ in got if n in BACKWARD)
    assert all(ms > 0 for _, _, ms in got)
    assert graph.warmup_s > 0 and graph.capture_s > 0


def test_each_captured_span_lies_within_its_parent(trainer):
    spans = trainer.graph.spans
    trainer.graph.device_spans()            # waits for the last replay
    for name, parent, start, end in spans:
        if parent is None:
            continue
        p_start, p_end = spans[parent][2], spans[parent][3]
        assert p_start.elapsed_time(start) >= 0, name
        assert end.elapsed_time(p_end) >= 0, name


def test_the_counters_count_only_unprofiled_replays(trainer):
    graph = trainer.graph
    assert graph.first_replay_s > 0
    assert graph.replays == 1
    assert 0 < graph.replay_host_s
    # the profiled replay is a host span; its kernels' device time is in
    # the graph's events
    assert [s.name for s in tracing.spans()] == ["search.replay"]
    trainer.search_step(*_pairs(1)[0])
    assert graph.replays == 2


def test_device_spans_describe_the_last_unprofiled_replay(trainer):
    """The reading held from before the profiled replay, until an
    unprofiled replay records the events anew."""
    graph = trainer.graph
    held = graph.device_spans()
    assert held is graph._held and graph._profiled
    trainer.search_step(*_pairs(1)[0])
    assert graph._held is None and not graph._profiled
    fresh = graph.device_spans()
    assert [n for n, _, _ in fresh] == [n for n, _, _ in held]


def test_a_served_frame_reads_its_stages_on_the_card(cuda):
    pipe = rt.Pipeline("Bayer_01_Demosaic_03_sRGB_01_13_11", device=cuda)
    serve = deploy.make_serving_fn(pipe, patch=64, stride=48, chunk=4,
                                   device=cuda)
    x = torch.rand(1, 128, 192, 1, device=cuda)
    serve(x)
    with tracing.enable():
        serve(x)
    spans = tracing.spans()
    assert spans[0].name == "serve.frame" and spans[0].device_s is None
    timed = [s for s in spans if s.name.startswith(("pipeline.",
                                                    "serve.blend"))]
    assert timed and all(s.device_s is not None and s.device_s > 0
                         for s in timed)

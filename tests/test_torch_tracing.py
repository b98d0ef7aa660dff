"""The port's spans (utils/tracing.py) on the CPU: off, nothing is recorded
and one shared no-op is returned; on, a served frame and a DARTS step record
their span trees, a profiler shows the same spans as nested annotations, and
the step's results and an exported artifact's output are the same with
spans on and off.  The graph's captured spans need the card:
tests/test_torch_tracing_cuda.py."""

import numpy as np
import pytest
import torch

import reconfigisp_tpu_torch as rt
from reconfigisp_tpu_torch import deploy
from reconfigisp_tpu_torch.ops.kernels import _vjp
from reconfigisp_tpu_torch.ops.kernels import bilateral as kb
from reconfigisp_tpu_torch.search.darts import (
    DartsConfig, init_darts_opt_state, make_darts_step)
from reconfigisp_tpu_torch.supernet import SuperNet
from reconfigisp_tpu_torch.utils import losses, tracing
from torch_one_thread import one_thread  # noqa: F401  (autouse)

ARCH = "Bayer_01_Demosaic_03_sRGB_01_13_11"
FRAME = (1, 64, 96, 1)
TILING = {"patch": 32, "stride": 24, "chunk": 4}   # 12 positions, 3 chunks
PASSES = ("darts.virtual", "darts.unrolled", "darts.hessian_pos",
          "darts.hessian_neg", "darts.update")
WINDOWED = ("bilateral", "median", "fastnlm")


@pytest.fixture(autouse=True)
def fresh_store():
    tracing.reset()
    yield
    tracing.reset()


def _mosaic(seed=5, shape=FRAME):
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        0, 1, shape).astype(np.float32))


def _pipe():
    return rt.Pipeline(ARCH, device="cpu")


def test_off_a_span_is_the_one_shared_no_op_and_records_nothing():
    assert not tracing.profiling()
    first, second = tracing.span("a"), tracing.span("b", device=True)
    assert first is second
    with first, second:
        pass
    serve = deploy.make_serving_fn(_pipe(), device="cpu", **TILING)
    serve(_mosaic())
    assert tracing.spans() == []
    with tracing.enable():
        assert tracing.span("a") is not tracing.span("a")


def _children(spans, index):
    return [i for i, s in enumerate(spans) if s.parent == index]


def test_a_served_frame_records_its_span_tree():
    serve = deploy.make_serving_fn(_pipe(), device="cpu", **TILING)
    with tracing.enable():
        serve(_mosaic(1))
        serve(_mosaic(2))
    spans = tracing.spans()
    roots = [i for i, s in enumerate(spans) if s.parent is None]
    assert [spans[i].name for i in roots] == ["serve.frame"] * 2
    steps = ["pipeline.bayer.path_bayer", "pipeline.demosaic.laplacian",
             "pipeline.srgb.gamma", "pipeline.srgb.wbquadratic",
             "pipeline.srgb.wbmanual"]
    for request, root in enumerate(roots):
        tree = [s for s in spans if s.request == request]
        assert spans[root].request == request
        assert len(tree) == 1 + 3 * (1 + len(steps) + 1) + 1
        chunks = _children(spans, root)
        assert [spans[i].name for i in chunks] == ["serve.chunk"] * 3 + [
            "serve.blend"]
        for c in chunks[:3]:
            assert [spans[i].name for i in _children(spans, c)] == \
                steps + ["serve.blend"]
        assert all(s.host_s is not None and s.host_s >= 0 for s in tree)
        assert all(s.device_s is None for s in tree)   # no card here
        # a child's host time lies within its parent's
        for i, s in enumerate(tree):
            if s.parent is not None:
                assert s.host_s <= spans[s.parent].host_s
    tracing.reset()
    assert tracing.spans() == []


def test_under_the_profiler_the_spans_are_nested_annotations():
    serve = deploy.make_serving_fn(_pipe(), device="cpu", **TILING)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        serve(_mosaic(3))
    events = {e.name: e for e in prof.events()
              if e.name.startswith(("serve.", "pipeline."))}
    recorded = tracing.spans()
    assert {s.name for s in recorded} == set(events)
    assert events.keys() >= {"serve.frame", "serve.chunk", "serve.blend",
                             "pipeline.bayer.path_bayer"}
    frame = events["serve.frame"].time_range
    for name, e in events.items():
        assert frame.start <= e.time_range.start <= e.time_range.end \
            <= frame.end, name
    assert not tracing.profiling()


def _darts(order):
    net = SuperNet(1, 0.2, srgb_count=9, device="cpu")
    variables = net.init()

    def forward(theta, alphas, omega, img):
        y, aux = net({"theta": theta, "alphas": alphas, "omega": omega},
                     img, return_aux=True)
        return y, aux["latency"]

    step = make_darts_step(forward, losses.make_criterion("l2"),
                           DartsConfig(lr_theta=1e-2, lr_alpha=1e-2,
                                       lr_meta=1e-2, order=order))
    rng = np.random.default_rng(8)
    batch = {k: torch.from_numpy(rng.uniform(
        0.05, 0.95, (2, 16, 16, 1 if "img" in k else 3)).astype(np.float32))
        for k in ("img", "gt", "val_img", "val_gt")}
    return step, variables, init_darts_opt_state(variables), batch


@pytest.fixture
def through_the_ops(monkeypatch):
    """The windowed ops through their custom ops on the CPU too, whose
    backward op is what a CUDA step runs (the wrappers otherwise
    differentiate the plain forms themselves on the CPU)."""
    monkeypatch.setattr(_vjp, "plain_here", lambda op, x, params: False)


def test_a_native_step_records_its_passes_and_the_backward_ops(
        through_the_ops):
    step, variables, opt_state, batch = _darts(2)
    with tracing.enable():
        step(variables, opt_state, batch, 1.0)
    spans = tracing.spans()
    assert spans[0].name == "darts.step" and spans[0].parent is None
    passes = _children(spans, 0)
    assert [spans[i].name for i in passes] == list(PASSES)
    backward = [s for s in spans if s.name.endswith(".backward")]
    assert {s.name for s in backward} == {f"{op}.backward"
                                          for op in WINDOWED}
    assert all(spans[s.parent].name in PASSES for s in backward)
    for i in passes:
        assert any(spans[j].name.endswith(".backward")
                   for j in _children(spans, i)), spans[i].name
    assert {s.request for s in spans} == {0}
    assert all(s.device_s is None for s in spans)


def _flat(tree):
    """The tensors of a step's (variables, optimiser state, logs)."""
    if isinstance(tree, torch.nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flat(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _flat(t)]
    return [tree]


@pytest.mark.parametrize("order,names", [
    (1, ("darts.alpha", "darts.update")), (2, PASSES)])
def test_a_step_is_bit_equal_with_spans_on_and_off(order, names,
                                                   through_the_ops):
    step, variables, opt_state, batch = _darts(order)
    off = step(variables, opt_state, batch, 0.5)
    assert tracing.spans() == []
    with tracing.enable():
        on = step(variables, opt_state, batch, 0.5)
    spans = tracing.spans()
    assert tuple(spans[i].name for i in _children(spans, 0)) == names
    off, on = _flat(off), _flat(on)
    assert len(off) == len(on) > 10
    for a, b in zip(off, on):
        assert torch.equal(a, b)


def test_an_exported_artifact_serves_as_before():
    pipe = _pipe()
    x = _mosaic(4)
    want = deploy.make_serving_fn(pipe, device="cpu", **TILING)(x)
    with tracing.enable():
        blob = deploy.export_pipeline(pipe, FRAME, **TILING)
    assert tracing.spans() == []          # nothing is traced into it
    loaded = deploy.load_pipeline(blob, device="cpu")
    off = loaded(x)
    with tracing.enable():
        on = loaded(x)
    assert torch.equal(off, on)
    assert float((off - want).abs().max()) <= 1e-5


def test_graph_spans_collect_nothing_outside_a_capture():
    with tracing.graph_spans() as captured, tracing.enable():
        with tracing.span("outer"):
            with tracing.span("inner"):
                pass
    assert captured == []
    assert [(s.name, s.parent) for s in tracing.spans()] == [
        ("outer", None), ("inner", 0)]
    assert tracing._graph is None


def test_reset_refuses_an_open_span():
    with tracing.enable(), tracing.span("open"):
        with pytest.raises(RuntimeError, match="open"):
            tracing.reset()
    assert [s.name for s in tracing.spans()] == ["open"]


def test_count_launches_adds_each_kernel_tally_in_one_call(monkeypatch):
    calls = []
    monkeypatch.setitem(_vjp._on_launch, "median", calls.append)
    before = kb.launches
    _vjp.count_launches({"bilateral": 45, "median": 45, "fastnlm": 0})
    assert kb.launches == before + 45
    assert calls == [45]
    kb.launches = before

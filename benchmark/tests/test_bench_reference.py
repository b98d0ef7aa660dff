"""The plain reference agrees with the port on the CPU at a tiny size: every
op of the search space, native and proxy, in value and gradient; a served
frame; the search's first three steps.  And the controls below the stated
precision fail the limits.

    python -m pytest benchmark/tests/test_bench_reference.py -q
"""

from __future__ import annotations

import sys
import zlib
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import run  # noqa: E402
from benchmark.lib import spec, weights  # noqa: E402
from benchmark.reference import search as refsearch  # noqa: E402
from benchmark.reference import zoo  # noqa: E402
from benchmark.tests.tiny import tiny_root  # noqa: E402
from reconfigisp_tpu_torch import registry  # noqa: E402

DOMAINS = {"bayer": zoo.BAYER, "demosaic": zoo.DEMOSAIC, "srgb": zoo.SRGB}
CASES = [(d, op, proxy) for d, ops in DOMAINS.items() for op in ops
         for proxy in (False, True)
         if proxy is False or zoo.runs_proxy(op, True)
         and not zoo.runs_proxy(op, False)]


def _operands(domain, op, proxy, gen):
    c = 1 if domain in ("bayer", "demosaic") else 3
    x = torch.rand((2, 16, 16, c), generator=gen)
    logits = (torch.tensor(zoo.INIT_LOGITS[op]) + 0.3 * torch.randn(
        len(zoo.INIT_LOGITS[op]), generator=gen)) if op in zoo.INIT_LOGITS \
        else None
    kind = zoo.module_kind(op, proxy)
    convs = None
    if kind:
        zero = ({op: len(zoo.INIT_LOGITS[op])} if kind == "srcnn_res"
                else None)
        convs = weights.draw_modules(gen, {op: kind}, "cpu", zero)[op]
    return x, logits, kind, convs


@pytest.mark.parametrize("domain,op,proxy", CASES)
def test_op_matches_the_port_in_value_and_gradient(domain, op, proxy):
    gen = torch.Generator().manual_seed(
        zlib.crc32(f"{domain}/{op}/{proxy}".encode()))
    x, logits, kind, convs = _operands(domain, op, proxy, gen)
    spec_ = registry.get_op(domain, op)
    module = None
    if kind:
        module = spec_.get_init(proxy)(torch.Generator().manual_seed(0))
        module.load_state_dict(weights.program_state_dict(kind, convs))

    def port(x_, l_):
        p = None if l_ is None else torch.sigmoid(l_)[None].expand(
            x_.shape[0], l_.shape[0])
        return spec_.get_apply(proxy)(x_, p, module)

    def ref(x_, l_):
        p = None if l_ is None else torch.sigmoid(l_)[None].expand(
            x_.shape[0], l_.shape[0])
        return refsearch.apply_op(op, x_, p, {op: convs}, proxy)

    outs, grads = [], []
    g = torch.rand(x.shape[:3] + ((1,) if domain == "bayer" else (3,)),
                   generator=gen)
    for fn in (port, ref):
        xs = x.clone().requires_grad_(True)
        ls = None if logits is None else logits.clone().requires_grad_(True)
        y = fn(xs, ls)
        wrt = [xs] + ([ls] if ls is not None else [])
        gs = torch.autograd.grad((y * g).sum(), wrt, allow_unused=True,
                                 materialize_grads=True)
        outs.append(y.detach())
        grads.append(gs)
    assert torch.allclose(outs[0], outs[1], atol=2e-6, rtol=0)
    for a, b in zip(*grads):
        assert torch.allclose(a, b, atol=1e-4 * max(1.0, float(b.abs().max())),
                              rtol=0), op


@pytest.mark.parametrize("storage", ["f32", "bf16"])
def test_a_served_frame_matches_and_the_control_fails(tmp_path, storage):
    tiny_root(tmp_path, storage=storage)
    cell = spec.load("tiny_serve", root=tmp_path)
    result = run.execute(cell, 3 ** 21, 0.3, False, "cpu")
    assert result["correct"] is True
    d = cell.system().System(cell, 11, torch.device("cpu"))
    with d.context():
        d.setup()
        d.window(0.2, False)
    d.release()
    ref = d.reference(d.modes()["stated"])
    if storage == "bf16":   # fp8 runs on the CPU; TF32 needs the card
        got = d.compare(d.reference("fp8"), ref)
        assert any(got[k] > v for k, v in cell.limits["limits"].items())


@pytest.mark.parametrize("use_proxies", [False, True])
def test_the_first_search_steps_match(tmp_path, use_proxies):
    tiny_root(tmp_path, use_proxies=use_proxies)
    cell = spec.load("tiny_search", root=tmp_path)
    result = run.execute(cell, 2 ** 33 + 1, 0.2, False, "cpu")
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= 1

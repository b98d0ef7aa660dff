"""On the card: a tiny cell of each kind is correct, and its control, the
reference in the next lower precision in the program's place (TF32 for
float32), fails the limits of the cell it shrinks.  Skips without a card.

    python -m pytest -m cuda benchmark/tests/test_bench_cuda.py -q
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import run  # noqa: E402
from benchmark.lib import spec  # noqa: E402
from benchmark.tests.tiny import tiny_root  # noqa: E402

CASES = [("tiny_serve", {"storage": "f32"}),
         ("tiny_serve", {"storage": "bf16"}),
         ("tiny_search", {"use_proxies": False}),
         ("tiny_search", {"use_proxies": True})]


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw", CASES)
def test_tiny_cell_is_correct_and_its_control_is_not(tmp_path, name, kw):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    tiny_root(tmp_path, **kw)
    cell = spec.load(name, root=tmp_path)
    result = run.execute(cell, 2 ** 35 + 3, 0.5, False, "cuda:0")
    assert result["correct"] is True, result["checks"]
    d = cell.system().System(cell, 2 ** 35 + 4, torch.device("cuda:0"))
    with d.context():
        d.setup()
        d.window(0.2, False)
    d.release()
    modes = d.modes()
    stated = d.reference(modes["stated"])
    assert all(v <= cell.limits["limits"][k]
               for k, v in d.compare(d.answers(), stated).items())
    control = d.compare(d.reference(modes["control"]), stated)
    assert any(control[k] > v for k, v in cell.limits["limits"].items()), \
        control

"""A run with the timed path broken underneath comes out not correct.

Each test drives the rest of a run (set-up, window, check) on the CPU at a
tiny size, with one of the faults that a cell can have planted in the
program: a served frame altered where it is produced; a search step that
returns its state unchanged; a step that leaves half of its batch out and
takes the mean over the rest; and, from the first step after the three that
set-up checks, a step that returns its state unchanged or that runs on the
first step's batch again (a stale input of a replayed graph).  The cells
run on one chip, so there is no exchange between chips to leave out.

    python -m pytest benchmark/tests/test_bench_faults.py -q
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import run  # noqa: E402
from benchmark.lib import spec  # noqa: E402
from benchmark.tests.tiny import tiny_root  # noqa: E402
from reconfigisp_tpu_torch import deploy  # noqa: E402
from reconfigisp_tpu_torch.search import trainer  # noqa: E402


def _altered_serving(real):
    def make(*args, **kw):
        serve = real(*args, **kw)

        def altered(x):
            y = serve(x).clone()
            y[0, 0, 0, 0] = 1.0 - y[0, 0, 0, 0]
            return y
        return altered
    return make


def _broken_step(real, fault):
    """make_darts_step with `fault` planted; a fault named *_late acts from
    the fourth call on, past the steps that set-up checks."""
    def make(*args, **kw):
        step = real(*args, **kw)
        calls = []

        def broken(variables, opt_state, batch, lr_scale):
            calls.append(batch)
            late = len(calls) > 3
            if fault == "half_batch":
                batch = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
            if fault == "stale_batch_late" and late:
                batch = calls[0]
            new_vars, new_opt, logs = step(variables, opt_state, batch,
                                           lr_scale)
            if fault == "unchanged" or (fault == "unchanged_late" and late):
                return variables, opt_state, logs
            return new_vars, new_opt, logs
        broken.space = step.space
        return broken
    return make


def test_an_altered_frame_is_not_correct(tmp_path, monkeypatch):
    tiny_root(tmp_path)
    monkeypatch.setattr(deploy, "make_serving_fn",
                        _altered_serving(deploy.make_serving_fn))
    result = run.execute(spec.load("tiny_serve", root=tmp_path), 5, 0.3,
                         False, "cpu")
    assert result["correct"] is False
    assert result["checks"]["max_abs"]["value"] > \
        result["checks"]["max_abs"]["limit"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch",
                                   "unchanged_late", "stale_batch_late"])
@pytest.mark.parametrize("use_proxies", [False, True])
def test_a_broken_step_is_not_correct(tmp_path, monkeypatch, fault,
                                      use_proxies):
    tiny_root(tmp_path, use_proxies=use_proxies)
    monkeypatch.setattr(trainer, "make_darts_step",
                        _broken_step(trainer.make_darts_step, fault))
    result = run.execute(spec.load("tiny_search", root=tmp_path), 6, 0.2,
                         False, "cpu")
    assert result["correct"] is False, result["checks"]
    if fault.endswith("_late"):
        first = ("loss_gap", "grad_gap", "change_gap")
        assert all(result["checks"][k]["value"] <=
                   result["checks"][k]["limit"] for k in first)

"""The port's run_training against the JAX package's for model darts
(order 2, srgb_count 4, 16x16 crops, as tests/test_trainer.py runs it),
through checkpoints, on the CPU: the method and tolerances of
tests/test_torch_run_training.py, whose fixtures and checks this file
shares (one file each, so the two JAX compiles of each run in parallel)."""

import shutil

from reconfigisp_tpu_torch import config
from reconfigisp_tpu_torch.search import run_training

from test_torch_run_training import (  # noqa: F401  (fixtures)
    N, _options, _with, assert_resumed_run_matches_jax, latency_restored,
    runs)
from torch_one_thread import one_thread  # noqa: F401  (autouse)


def test_resumed_run_matches_jax(runs):
    assert_resumed_run_matches_jax(runs("darts"), "darts")


def test_resume_when_complete_reports_the_saved_loss(runs, tmp_path):
    """Resumed at N with niter N, the port runs no step and reports the
    checkpointed loss (the JAX package's behaviour)."""
    run = runs("darts")
    root = tmp_path / "again"
    shutil.copytree(run["tmp"] / "port" / "experiments",
                    root / "experiments")
    opt = _with(_options("darts", tmp_path), N, N)
    summary = run_training(config.parse_dict(opt, root=str(root)),
                           device="cpu")
    assert summary["steps"] == N and summary["steps_run"] == 0
    assert summary["loss"] == run["port"]["loss"]



"""`dist: true` through the train CLI under torchrun, on two CPU ranks.

configs/synthetic_search.yaml with `dist: true` and a checkpoint every step
runs as a user launches it, `python -m torch.distributed.run --standalone
--nproc-per-node 2` over the port's train CLI (through a runner that
records which rank saved which file and then calls the CLI's main), in a
subprocess whose working directory is a temporary root.  The port's serial
run_training on the same options is the reference; it is held to the JAX
package's by tests/test_torch_run_training_darts.py.  Checked: the final
checkpoint's alphas and theta within 1e-5 of the serial run's
(tests/test_torch_darts.py's theta tolerance; the ranks' shares sum the
same losses in another order), every file saved by rank 0 alone and as
often as the serial run saves it, one summary printed; a batch of 3 over
2 ranks stops both with dist_mesh's ValueError.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

from reconfigisp_tpu_torch import config
from reconfigisp_tpu_torch.search import run_training
from reconfigisp_tpu_torch.utils import checkpoint

REPO = Path(__file__).resolve().parents[1]
ATOL = 1e-5

# Records "<RANK> <path relative to the root>" of every checkpoint and
# training state the process saves, then runs the CLI.
RUNNER = """
import os, sys
from reconfigisp_tpu_torch.utils import checkpoint

def logged(save):
    def wrapper(path_dir, iter_label, *args, **kw):
        path = save(path_dir, iter_label, *args, **kw)
        with open(os.environ["SAVES_LOG"], "a") as f:
            f.write(f"{os.environ['RANK']} {os.path.relpath(path)}\\n")
        return path
    return wrapper

checkpoint.save_network = logged(checkpoint.save_network)
checkpoint.save_training_state = logged(checkpoint.save_training_state)
from reconfigisp_tpu_torch.train import main
sys.exit(main())
"""


def _options(batch_size):
    opt = yaml.safe_load(open(REPO / "configs" / "synthetic_search.yaml"))
    opt["dist"] = True
    opt["datasets"]["train"]["batch_size"] = batch_size
    opt["logger"] = {"print_freq": 1, "save_checkpoint_freq": 1}
    return opt


def _torchrun(root: Path, batch_size: int):
    root.mkdir(parents=True)
    (root / "opt.yaml").write_text(yaml.safe_dump(_options(batch_size)))
    (root / "runner.py").write_text(RUNNER)
    env = dict(os.environ, SAVES_LOG=str(root / "saves.log"),
               PYTHONPATH=os.pathsep.join(
                   [str(REPO)] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "runner.py", "--opt", "opt.yaml",
         "--niter", "2", "--device", "cpu"],
        cwd=str(root), env=env, capture_output=True, text=True, timeout=300)


def test_dist_search_through_torchrun_equals_serial(tmp_path, monkeypatch):
    res = _torchrun(tmp_path / "dist", 4)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert res.stdout.count("training done:") == 1

    saves = []
    real = checkpoint.save_network

    def record(path_dir, iter_label, *args, **kw):
        path = real(path_dir, iter_label, *args, **kw)
        saves.append(os.path.relpath(path, tmp_path / "serial"))
        return path

    monkeypatch.setattr(checkpoint, "save_network", record)
    serial = run_training(config.parse_dict(
        _options(4), root=str(tmp_path / "serial")), max_iters=2,
        device="cpu")
    assert serial["steps"] == 2

    logged = [line.split() for line in
              (tmp_path / "dist" / "saves.log").read_text().splitlines()]
    assert {rank for rank, _ in logged} == {"0"}
    assert [p for _, p in logged if p.endswith(".ckpt")] == saves
    assert sum(p.endswith(".state") for _, p in logged) == len(saves)

    rel = Path("experiments") / "synthetic_search" / "models" / "2_G.ckpt"
    got = checkpoint.load_network(str(tmp_path / "dist" / rel))
    want = checkpoint.load_network(str(tmp_path / "serial" / rel))
    for part in ("alphas", "theta"):
        flat_got, flat_want = [], []
        for slot in want[part]:
            if part == "alphas":
                flat_got.append(got[part][slot])
                flat_want.append(want[part][slot])
            else:
                for op in want[part][slot]:
                    flat_got.append(got[part][slot][op])
                    flat_want.append(want[part][slot][op])
        for a, b in zip(flat_got, flat_want):
            np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)
    moved = max(float(np.abs(a - b).max()) for a, b in zip(
        got["alphas"].values(), checkpoint.load_network(str(
            tmp_path / "serial" / rel.parent / "1_G.ckpt"))["alphas"].values()))
    assert moved > 0.0   # the second step moved the alphas compared


def test_indivisible_batch_raises_through_torchrun(tmp_path):
    res = _torchrun(tmp_path / "odd", 3)
    assert res.returncode != 0
    assert "does not split over 2 ranks; launch 1 ranks" in res.stderr

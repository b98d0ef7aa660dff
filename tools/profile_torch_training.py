#!/usr/bin/env python3
"""Where the time goes in one step-2 training step of the port, on one GPU.

    python3 tools/profile_torch_training.py [--arch ARCH]

ARCH is an architecture string, by default chip_smoke.SLICE2 (median and
fast NLM); chip_smoke.SLICE1 trains through the bilateral.  Builds the
trainer and the batch of chip_smoke.py's phase 7 (SID_isp's options, the
bank's weights, the kernels on, TF32 off), takes two warm-up steps, and
profiles one step with tools/profile_torch_serving.profile_device: the
device time by kernel group, the busy share of the step's wall time and the
ten longest kernels.  Exits 1 without CUDA or when the profiler records no
device time.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (BANK, SLICE2, make_trainer,  # noqa: E402
                        make_training_batch, sid_isp_options, tf32_off)
from reconfigisp_tpu_torch.utils.checkpoint import load_network  # noqa: E402
from tools.profile_torch_serving import profile_device  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=SLICE2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile: CUDA is not available", file=sys.stderr)
        return 1
    tf32_off()
    dev = torch.device("cuda")
    _, use_proxy, train_opt, n, size = sid_isp_options()
    trainer = make_trainer(dev, args.arch, use_proxy,
                           load_network(str(BANK)), train_opt)
    batch = make_training_batch(dev, n, size)
    return profile_device(lambda: trainer.train_step(batch), 2,
                          f"arch={args.arch} steps=1")


if __name__ == "__main__":
    sys.exit(main())

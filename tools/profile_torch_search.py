#!/usr/bin/env python3
"""Where the time goes in one step-1 search step of the port, on one GPU.

    python3 tools/profile_torch_search.py [--order 1|2] [--remat on|off]

Builds the trainer and the batches of chip_smoke.py's phase 8
(configs/SID_search.yaml's supernet, native, 3 sRGB slots of 15 ops, omega
from the bank, a planted 4 x 48 x 48 train and val batch from seed 0, the
kernels on, TF32 off), takes two warm-up steps, and profiles one step with
tools/profile_torch_serving.profile_device: the device time by kernel
group, the busy share of the step's wall time and the ten longest kernels.
Exits 1 without CUDA or when the profiler records no device time.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (BANK, SID_SEARCH, make_planted_batch,  # noqa: E402
                        make_search_trainer, search_options, tf32_off)
from reconfigisp_tpu_torch.utils.checkpoint import load_network  # noqa: E402
from tools.profile_torch_serving import profile_device  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--order", type=int, default=2, choices=(1, 2))
    ap.add_argument("--remat", default="on", choices=("on", "off"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile: CUDA is not available", file=sys.stderr)
        return 1
    tf32_off()
    dev = torch.device("cuda")
    opt = search_options(SID_SEARCH)
    trainer = make_search_trainer(dev, load_network(str(BANK)), opt,
                                  remat=args.remat == "on", order=args.order)
    data = opt["datasets"]["train"]
    gen = torch.Generator(device=dev).manual_seed(0)
    train = make_planted_batch(dev, data["batch_size"], data["data_size"], gen)
    val = make_planted_batch(dev, data["batch_size"], data["data_size"], gen)
    return profile_device(lambda: trainer.search_step(train, val), 2,
                          f"order={args.order} remat={args.remat} steps=1")


if __name__ == "__main__":
    sys.exit(main())

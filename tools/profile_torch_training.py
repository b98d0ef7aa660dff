#!/usr/bin/env python3
"""Where the time goes in one step-2 training step of the port, on one GPU.

    python3 tools/profile_torch_training.py [--arch ARCH]

ARCH is an architecture string, by default SLICE2 (median and fast NLM);
Bayer_01_Demosaic_03_sRGB_07_01_13_11 trains through the bilateral.  Builds
configs/SID_isp.yaml's trainer (its options through the port's
config.parse, the in-repo bank's weights, the kernels on, TF32 off) and one
batch of its crops, planted scenes made on the card from seed 0 by the
benchmark's generator (benchmark/generators/planted_pairs.py with
benchmark/traffic/sid_crops.json's scene), takes two warm-up steps, and
profiles one step (benchmark/lib/trace.capture): the device time by kernel
group, the busy share of the step's wall time and the ten longest kernels.
Exits 1 without CUDA; raises when the profiler records no device time.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark.generators import planted_pairs  # noqa: E402
from benchmark.lib import trace  # noqa: E402
from benchmark.lib.device import nvidia_smi, tf32  # noqa: E402
from reconfigisp_tpu_torch import Pipeline, config, convert  # noqa: E402
from reconfigisp_tpu_torch.search import IspTrainer  # noqa: E402
from reconfigisp_tpu_torch.utils.checkpoint import load_network  # noqa: E402

SLICE2 = "Bayer_01_Demosaic_03_sRGB_08_09_01_13_11"
BANK = ROOT / "experiments" / "proxies" / "default.ckpt"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=SLICE2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as root:
        opt = config.parse(str(ROOT / "configs" / "SID_isp.yaml"), root=root)
    pipe = Pipeline(args.arch, config.network_uses_proxy(opt["network_G"]),
                    device=dev)
    pipe.load_state(convert.state_from_bank(load_network(str(BANK)), pipe))
    trainer = IspTrainer(pipe, opt["train"])
    data = opt["datasets"]["train"]
    scene = json.loads((ROOT / "benchmark" / "traffic" / "sid_crops.json")
                       .read_text())
    pair = planted_pairs.make(dict(scene, pairs=1, batch=data["batch_size"],
                                   crop=data["data_size"]), 0, dev)
    batch = {"noisy": pair["noisy"][0, 0], "gt": pair["gt"][0, 0]}
    with tf32(False):
        for _ in range(2):
            trainer.train_step(batch)
        tr = trace.capture(lambda: trainer.train_step(batch), dev)
    wall_ms, busy_ms = tr.window_s * 1e3, tr.busy_s * 1e3
    groups = tr.by_group()
    kernel_ms = sum(groups.values()) * 1e3
    print(f"nvidia-smi: {nvidia_smi()}")
    print(f"device: {torch.cuda.get_device_name(dev)} arch={args.arch} "
          f"steps=1 wall_ms={wall_ms:.3f} kernel_ms={kernel_ms:.3f} "
          f"busy_ms={busy_ms:.3f} busy_share={busy_ms / wall_ms:.4f} "
          f"kernels={len(tr.kernels)}")
    for group, s in sorted(groups.items(), key=lambda t: -t[1]):
        print(f"group {group}: ms={s * 1e3:.3f} "
              f"share={s * 1e3 / kernel_ms:.4f}")
    by_name: dict = {}
    for name, start, end in tr.kernels:
        by_name[name] = by_name.get(name, 0.0) + (end - start) / 1e3
    for name, ms in sorted(by_name.items(), key=lambda t: -t[1])[:10]:
        print(f"kernel ms={ms:.3f} {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

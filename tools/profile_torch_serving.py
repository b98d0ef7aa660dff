#!/usr/bin/env python3
"""Where the time goes in the port's SID serving path, on one NVIDIA GPU.

    python3 tools/profile_torch_serving.py [--storage f32|bf16]

Serves the two frames of chip_smoke.py's phase 4 through the same pipeline
and serving function (its set-up is imported from there, TF32 off), once to
warm up and once under torch.profiler.  Prints
the device time by kernel group, the device busy share of the call's wall
time, and the ten longest kernels.  Exits 1 without CUDA or when the
profiler records no device time.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (load_pipeline, make_frames, make_serve,  # noqa: E402
                        nvidia_smi, tf32_off)
from reconfigisp_tpu_torch import precision  # noqa: E402

# kernel-name fragments -> group, first match wins
_GROUPS = (("bilateral", "bilateral kernel"),
           ("nchwtonhwc", "layout"), ("nhwctonchw", "layout"),
           ("transpose", "layout"),
           ("conv", "convolution"), ("xmma", "convolution"),
           ("gemm", "convolution"), ("cudnn", "convolution"),
           ("copy", "copy"), ("memcpy", "copy"), ("memset", "copy"),
           ("reduce", "reduction"))


def _group(name: str) -> str:
    low = name.lower()
    for frag, group in _GROUPS:
        if frag in low:
            return group
    return "elementwise"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--storage", default="f32", choices=("f32", "bf16"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile: CUDA is not available", file=sys.stderr)
        return 1
    tf32_off()
    dev = torch.device("cuda")
    serve = make_serve(load_pipeline(dev), dev)
    frames = make_frames(dev)

    with precision.cnn_storage(args.storage):
        serve(frames)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            serve(frames)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print("profile: the profiler recorded no device time", file=sys.stderr)
        return 1
    by_group: dict = {}
    by_name: dict = {}
    spans = []
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_group[_group(e.name)] = by_group.get(_group(e.name), 0.0) + us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        spans.append((e.time_range.start, e.time_range.end))
    kernel_ms = sum(by_group.values()) / 1e3
    busy_us, reach = 0.0, None   # union of kernel spans: overlap counted once
    for start, end in sorted(spans):
        if reach is None or start > reach:
            busy_us += end - start
            reach = end
        elif end > reach:
            busy_us += end - reach
            reach = end
    busy_ms = busy_us / 1e3
    print(f"nvidia-smi: {nvidia_smi()}")
    print(f"device: {torch.cuda.get_device_name(0)} storage={args.storage} "
          f"frames=2 wall_ms={wall_ms:.3f} "
          f"kernel_ms={kernel_ms:.3f} busy_ms={busy_ms:.3f} "
          f"busy_share={busy_ms / wall_ms:.4f} "
          f"kernels={len(kernels)}")
    for group, us in sorted(by_group.items(), key=lambda t: -t[1]):
        print(f"group {group}: ms={us / 1e3:.3f} "
              f"share={us / 1e3 / kernel_ms:.4f}")
    for name, us in sorted(by_name.items(), key=lambda t: -t[1])[:10]:
        print(f"kernel ms={us / 1e3:.3f} {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Fast NLM's backward on one GPU: the backward kernel against the plain
form's autograd that it replaced, beside its bound.

    python3 tools/time_fastnlm_backward.py [--shape 4,48,48,3] [--search 4]
        [--blocks 1,4,7] [--reps 50] [--profile]

For each block radius, on x uniform in [0, 1], a cotangent from a normal
draw, every image at search radius `--search` and decay 0.5 (h = 50.5, the
search cell's initial params), one application of each, captured in a CUDA
graph and replayed `--reps` times between CUDA events (as the search step
runs them):
  - kernel_ms: csrc/fastnlm.cu's backward (ops/kernels/fastnlm.py
    backward_kernel), its launches and its launch groups;
  - plain_ms: _vjp.vjp of fastnlm_plain on its capture-safe route (every
    offset to MAX_R, boxes stacked), what the step captured before;
  - bound_ms: chip_smoke.fastnlm_backward_bound and what bounds it;
  - gx_err, gp_err: the kernel's largest gap to the plain form's eager
    gradient, over the largest reference value.
With --profile, each of the kernel's four kernels' device time an
application (torch.profiler over the replays).  Prints the card's name and
power limit first.  Exits 1 without CUDA.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (event_ms, fastnlm_backward_bound, line,  # noqa: E402
                        nvidia_smi, size01)
from reconfigisp_tpu_torch.ops.kernels import _vjp  # noqa: E402
from reconfigisp_tpu_torch.ops.kernels import fastnlm as kf  # noqa: E402


def graphed(fn):
    """fn captured once in a CUDA graph (after a warm-up call on a side
    stream) -> its replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay


def kernel_breakdown(replay, reps: int) -> dict:
    """{kernel name: device ms an application} over `reps` replays."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            replay()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if "fastnlm_bwd" in ev.key:
            name = ev.key.split("fastnlm_bwd_")[1].split("(")[0]
            out[name] = ev.device_time_total / 1e3 / reps
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", default="4,48,48,3")
    ap.add_argument("--search", type=int, default=4)
    ap.add_argument("--blocks", default="1,4,7")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_fastnlm_backward: needs CUDA", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    shape = tuple(int(v) for v in args.shape.split(","))
    line("card", name_power_limit=nvidia_smi(), torch=torch.__version__)
    gen = torch.Generator(dev).manual_seed(21)
    x = torch.rand(shape, device=dev, generator=gen)
    g = torch.randn(shape, device=dev, generator=gen)
    for block in (int(v) for v in args.blocks.split(",")):
        p = torch.tensor([[size01(block) if i == 0 else 0.0,
                           size01(args.search), 0.5]
                          for i in range(shape[0])], device=dev)
        got = kf.backward_kernel(x, p, g)
        want = _vjp.vjp(kf.fastnlm_plain, kf.HALO, x, p, g)
        errs = [float((a - b).abs().max() / b.abs().max())
                for a, b in zip(got[:2], want)]
        kernel = graphed(lambda: kf.backward_kernel(x, p, g))
        with _vjp.static_bounds():
            plain = graphed(lambda: _vjp.vjp(kf.fastnlm_plain, kf.HALO, x,
                                             p, g))
        kernel_ms = event_ms(kernel, args.reps)
        plain_ms = event_ms(plain, max(1, args.reps // 10))
        bound_ms, bound_by = fastnlm_backward_bound(x, p)
        line("fastnlm backward", shape=shape, block=block,
             search=args.search, kernel_ms=f"{kernel_ms:.5f}",
             launches=got[2], group=kf.backward_group(x),
             plain_ms=f"{plain_ms:.5f}", bound_ms=f"{bound_ms:.5f}",
             bound_by=bound_by,
             roofline_pct=f"{100 * bound_ms / kernel_ms:.3f}",
             gx_err=f"{errs[0]:.3e}", gp_err=f"{errs[1]:.3e}")
        if args.profile:
            split = kernel_breakdown(kernel, args.reps)
            line("fastnlm backward kernels", block=block,
                 **{k: f"{v:.5f}" for k, v in split.items()})
    return 0


if __name__ == "__main__":
    sys.exit(main())

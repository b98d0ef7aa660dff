#!/usr/bin/env python3
"""A windowed op's backward kernel on one GPU, against the plain form's
autograd that it replaced, beside its bound.

    python3 tools/time_backward.py --op bilateral|fastnlm
        [--shape 4,48,48,3] [--radii 1,4,7] [--search 4] [--reps 50]
        [--profile]

For each radius (the bilateral's window radius, fast NLM's block radius
with every image at search radius `--search`), on x uniform in [0, 1], a
cotangent from a normal draw, and the other params 0.5 (the bilateral's
sigmas, fast NLM's decay: 50.5), one application of each, captured in a
CUDA graph and replayed `--reps` times between CUDA events (as the search
step runs them):
  - kernel_ms: the op's backward kernel (ops/kernels/<op>.py
    backward_kernel) and its launches;
  - plain_ms: _vjp.vjp of the plain form on its capture-safe route (every
    tap or offset to MAX_R), what the step captured before;
  - bound_ms: chip_smoke.<op>_backward_bound and what bounds it;
  - gx_err, gp_err: the kernel's largest gap to the plain form's eager
    gradient, over the largest reference value.
With --profile, each of the kernel's kernels' device time an application
(torch.profiler over the replays).  Prints the card's name and power limit
first.  Exits 1 without CUDA.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (bilateral_backward_bound, event_ms,  # noqa: E402
                        fastnlm_backward_bound, line, nvidia_smi, size01)
from reconfigisp_tpu_torch.ops.kernels import _vjp  # noqa: E402
from reconfigisp_tpu_torch.ops.kernels import bilateral as kb  # noqa: E402
from reconfigisp_tpu_torch.ops.kernels import fastnlm as kf  # noqa: E402

OPS = {"bilateral": (kb, kb.bilateral_plain, bilateral_backward_bound),
       "fastnlm": (kf, kf.fastnlm_plain, fastnlm_backward_bound)}


def op_params(op: str, radius: int, search: int, n: int, dev):
    """(n, 3) params: the bilateral's window radius and sigmas 0.5; fast
    NLM's block radius (row 0), search radius and decay 0.5."""
    if op == "bilateral":
        rows = [[size01(radius), 0.5, 0.5]] * n
    else:
        rows = [[size01(radius) if i == 0 else 0.0, size01(search), 0.5]
                for i in range(n)]
    return torch.tensor(rows, device=dev)


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


def kernel_breakdown(op: str, replay, reps: int) -> dict:
    """{kernel name: device ms an application} over `reps` replays."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            replay()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if f"{op}_bwd" in ev.key:
            name = ev.key.split(f"{op}_bwd_")[1].split("(")[0].split("<")[0]
            out[name] = out.get(name, 0.0) + ev.device_time_total / 1e3 / reps
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--op", choices=sorted(OPS), required=True)
    ap.add_argument("--shape", default="4,48,48,3")
    ap.add_argument("--radii", default="1,4,7")
    ap.add_argument("--search", type=int, default=4)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_backward: needs CUDA", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    mod, plain, bound = OPS[args.op]
    shape = tuple(int(v) for v in args.shape.split(","))
    line("card", name_power_limit=nvidia_smi(), torch=torch.__version__)
    gen = torch.Generator(dev).manual_seed(21)
    x = torch.rand(shape, device=dev, generator=gen)
    g = torch.randn(shape, device=dev, generator=gen)
    for radius in (int(v) for v in args.radii.split(",")):
        p = op_params(args.op, radius, args.search, shape[0], dev)
        got = mod.backward_kernel(x, p, g)
        want = _vjp.vjp(plain, mod.HALO, x, p, g)
        errs = [float((a - b).abs().max() / b.abs().max())
                for a, b in zip(got[:2], want)]
        kernel = graphed(lambda: mod.backward_kernel(x, p, g))
        with _vjp.static_bounds():
            plain_replay = graphed(lambda: _vjp.vjp(plain, mod.HALO, x, p, g))
        kernel_ms = event_ms(kernel, args.reps)
        plain_ms = event_ms(plain_replay, max(1, args.reps // 10))
        bound_ms, bound_by = bound(x, p)
        search = {"search": args.search} if args.op == "fastnlm" else {}
        line(f"{args.op} backward", shape=shape, radius=radius, **search,
             kernel_ms=f"{kernel_ms:.5f}", launches=got[2],
             plain_ms=f"{plain_ms:.5f}", bound_ms=f"{bound_ms:.5f}",
             bound_by=bound_by,
             roofline_pct=f"{100 * bound_ms / kernel_ms:.3f}",
             gx_err=f"{errs[0]:.3e}", gp_err=f"{errs[1]:.3e}")
        if args.profile:
            split = kernel_breakdown(args.op, kernel, args.reps)
            line(f"{args.op} backward kernels", radius=radius,
                 **{k: f"{v:.5f}" for k, v in split.items()})
    return 0


if __name__ == "__main__":
    sys.exit(main())

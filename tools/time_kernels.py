#!/usr/bin/env python3
"""The hand kernels on one GPU: each forward kernel against its plain
PyTorch form, and each op's backward against the plain form's autograd,
beside their bounds.

    python3 tools/time_kernels.py [--op bilateral|median|fastnlm]
        [--shape 8,512,512,3] [--radii 4] [--search 4] [--reps 50]
        [--profile]

For each op (all three without --op) and each radius (the bilateral's and
the median's window radius, fast NLM's block radius with every image at
search radius `--search`), on x uniform in [0, 1], a cotangent from a
normal draw, and the other params 0.5 (the bilateral's sigmas, fast NLM's
decay: 50.5):
  - "<op> forward": the kernel's wrapper (kernel_ms) called eagerly
    `--reps` times between CUDA events, as serving calls it, its host
    dispatch included, and the plain form (plain_ms) the same way a tenth
    as often; bound_ms, benchmark/lib/counts.kernel_bound_s, and
    roofline_pct, the bound over the kernel's time; err, the kernel's
    largest gap to the plain form;
  - "<op> backward": one application captured and replayed the same way:
    the op's backward kernel (ops/kernels/<op>.py backward_kernel) and its
    launches; plain_ms, _vjp.vjp of the plain form on its capture-safe
    route (every tap or offset to MAX_R; the median's seven radii);
    bound_ms from BACKWARD_BOUNDS below; gx_err and gp_err, the kernel's
    largest gap to the plain form's eager gradient over the largest
    reference value (gp_err none for the median, whose params take no
    gradient).
With --profile, each of a backward kernel's kernels' device time an
application (torch.profiler over the replays).  The defaults are the
serving path's tile batch; the search step's crops are --shape 4,48,48,3
--radii 1,4,7.  Prints the card's name and power limit first.  Exits 1
without CUDA.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark.lib import counts  # noqa: E402
from benchmark.lib.device import nvidia_smi  # noqa: E402
from reconfigisp_tpu_torch.ops.kernels import _vjp  # noqa: E402
from reconfigisp_tpu_torch.ops.kernels import bilateral as kb  # noqa: E402
from reconfigisp_tpu_torch.ops.kernels import fastnlm as kf  # noqa: E402
from reconfigisp_tpu_torch.ops.kernels import median as km  # noqa: E402

# op -> (module, kernel wrapper, plain form)
OPS = {"bilateral": (kb, kb.bilateral, kb.bilateral_plain),
       "median": (km, km.median, km.median_plain),
       "fastnlm": (kf, kf.fastnlm, kf.fastnlm_plain)}


def bilateral_backward_s(shape, r: int) -> float:
    """Least seconds for the bilateral's gradient for x and params.  Bytes:
    x, params and the cotangent read and gx and gp written once.
    Operations, as counts.bilateral_ops counts them: the forward's again to
    form the weights, N and D (the op keeps no residuals), and 13 more a
    tap for the gradient: the weight's gradient (a subtract and two
    multiplies, 3), the centre's term (2) and its add (1), the tap's term
    A w - B (3), and the two params sums (4)."""
    n, h, w, c = shape
    flops, exps = counts.bilateral_ops(shape, r)
    taps = (2 * r + 1) ** 2 * n * h * w * c
    return counts._bound_s(3 * n * h * w * c * 4 + 2 * n * 3 * 4,
                    flops + 13 * taps, exps)


def fastnlm_backward_s(shape, s: int) -> float:
    """Least seconds for fast NLM's gradient for x and params at search
    radius s.  Bytes: x, params and the cotangent read and gx and gp
    written once.  Operations, as counts.fastnlm_ops counts them per
    distinct offset: the forward's 14 and one exp to form the weight again
    (the op keeps no residuals), and for each of the two pixels the offset
    pairs the weight's gradient (a subtract and a multiply, 2), the box
    sum's (2), the adjoint box with running sums (5), the difference's
    2 t gD (2) and three adds into gx (3): 28 more."""
    n, h, w, c = shape
    flops, distinct = counts.fastnlm_ops(shape, s)
    return counts._bound_s(3 * n * h * w * c * 4 + 2 * n * 3 * 4,
                    flops + 28 * distinct, distinct)


def median_backward_s(shape, r: int) -> float:
    """Least seconds for the median's gradient for x.  Bytes: x, params and
    the cotangent read and gx and gp written once.  Operations, as
    counts.median_ops counts them: the forward's K - 1 comparisons again to
    find each window's median (the op keeps no residuals), K to count the
    taps tied with it, and K to find the windows whose median each value
    is: 3 K - 1 a value, K = (2r+1)^2."""
    n, h, w, c = shape
    flops, _ = counts.median_ops(shape, r)
    taps = (2 * r + 1) ** 2 * n * h * w * c
    return counts._bound_s(3 * n * h * w * c * 4 + 2 * n * 4,
                           flops + 2 * taps, 0)


# op -> its backward's bound in seconds from (shape, window or search
# radius)
BACKWARD_BOUNDS = {"bilateral": bilateral_backward_s,
                   "median": median_backward_s,
                   "fastnlm": fastnlm_backward_s}


def line(what: str, **fields) -> None:
    print(f"{what}: " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def size01(radius: int) -> float:
    """A [0, 1] parameter whose mapped radius is `radius`."""
    return (radius - 0.5) / 7.0


def op_params(op: str, radius: int, search: int, n: int, dev):
    """(n, P) params: the bilateral's window radius and sigmas 0.5; the
    median's radius; fast NLM's block radius (row 0), search radius and
    decay 0.5."""
    if op == "bilateral":
        rows = [[size01(radius), 0.5, 0.5]] * n
    elif op == "median":
        rows = [[size01(radius)]] * n
    else:
        rows = [[size01(radius) if i == 0 else 0.0, size01(search), 0.5]
                for i in range(n)]
    return torch.tensor(rows, device=dev)


def event_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps calls, after one warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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


def time_op(op: str, x, g, radius: int, args) -> None:
    """The forward line and the backward line of one op at one radius."""
    mod, kernel, plain = OPS[op]
    shape = tuple(x.shape)
    p = op_params(op, radius, args.search, shape[0], x.device)
    # the bounds' radius: the window's, or fast NLM's search radius
    r = args.search if op == "fastnlm" else radius
    search = {"search": args.search} if op == "fastnlm" else {}

    kernel_ms = event_ms(lambda: kernel(x, p), args.reps)
    plain_ms = event_ms(lambda: plain(x, p), max(1, args.reps // 10))
    bound_ms = 1e3 * counts.kernel_bound_s(op, shape, r, radius)
    err = float((kernel(x, p) - plain(x, p)).abs().max())
    line(f"{op} forward", shape=shape, radius=radius, **search,
         kernel_ms=f"{kernel_ms:.5f}", plain_ms=f"{plain_ms:.5f}",
         bound_ms=f"{bound_ms:.5f}",
         roofline_pct=f"{100 * bound_ms / kernel_ms:.3f}", err=f"{err:.3e}")

    needs = (True, op != "median")
    with _vjp.static_bounds():
        plain_replay = graphed(lambda: _vjp.vjp(plain, mod.HALO, x, p, g,
                                                needs))
    plain_ms = event_ms(plain_replay, max(1, args.reps // 10))
    got = mod.backward_kernel(x, p, g)
    want = _vjp.vjp(plain, mod.HALO, x, p, g, needs)
    errs = [f"{float((a - b).abs().max() / b.abs().max()):.3e}"
            if b is not None else "none" for a, b in zip(got[:2], want)]
    replay = graphed(lambda: mod.backward_kernel(x, p, g))
    kernel_ms = event_ms(replay, args.reps)
    bound_ms = 1e3 * BACKWARD_BOUNDS[op](shape, r)
    line(f"{op} backward", shape=shape, radius=radius, **search,
         kernel_ms=f"{kernel_ms:.5f}", launches=got[2],
         plain_ms=f"{plain_ms:.5f}", bound_ms=f"{bound_ms:.5f}",
         roofline_pct=f"{100 * bound_ms / kernel_ms:.3f}",
         gx_err=errs[0], gp_err=errs[1])
    if args.profile:
        split = kernel_breakdown(op, replay, args.reps)
        line(f"{op} backward kernels", radius=radius,
             **{k: f"{v:.5f}" for k, v in split.items()})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--op", choices=sorted(OPS))
    ap.add_argument("--shape", default="8,512,512,3")
    ap.add_argument("--radii", default="4")
    ap.add_argument("--search", type=int, default=4)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_kernels: needs CUDA", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    shape = tuple(int(v) for v in args.shape.split(","))
    line("card", name_power_limit=nvidia_smi(), torch=torch.__version__)
    gen = torch.Generator(dev).manual_seed(21)
    x = torch.rand(shape, device=dev, generator=gen)
    g = torch.randn(shape, device=dev, generator=gen)
    for op in [args.op] if args.op else OPS:
        for radius in (int(v) for v in args.radii.split(",")):
            time_op(op, x, g, radius, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())

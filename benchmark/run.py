#!/usr/bin/env python3
"""One run of one benchmark cell of reconfigisp_tpu_torch on NVIDIA GPUs.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

From the root of a checkout.  The cell (an entry of BENCHMARK.json's
`workloads`) names its configuration and traffic; their files, its limits
and its metrics' readers are found by name (benchmark/lib/spec.py).  The run
sets up (process start to the first timed request is `setup_s`), measures
for S seconds, and checks what the window produced against the plain
reference (benchmark/reference/).  With --trace 0 it reports the cell's
end-to-end metrics; with --trace 1 it profiles a short stretch of the window
and reports the per-layer metrics instead.  The last line of standard
output is one JSON object (correct, attempted, failed, metrics, device,
with --trace 1 breakdown, and last `checks`: each number compared with its
limit); the last lines of standard error are the same checks.

Exits 3 without CUDA or with fewer devices than the cell asks for, and 4
when a module of JAX or of the JAX package is loaded once the window has
closed; neither prints a result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.lib import device as devlib  # noqa: E402

devlib.cache_env(ROOT)

import torch  # noqa: E402

from benchmark.lib import spec  # noqa: E402


class Run:
    """What the metric readers see: the window's record, the system's work
    counts, the profiled stretch's trace (or None) and the set-up time."""

    def __init__(self, system, record, setup_s):
        self.system = system
        self.record = record
        self.setup_s = setup_s
        self.trace = system.trace
        self.work = system.work()


def _number(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def execute(cell, seed: int, seconds: float, trace: bool, device) -> dict:
    """The run after the look for a chip: -> the result object."""
    device = torch.device(device)
    print(f"setup: torch imported at {time.perf_counter() - T0:.3f} s",
          file=sys.stderr, flush=True)
    system = cell.system().System(cell, seed, device)
    with system.context():
        system.setup()
        setup_s = time.perf_counter() - T0
        record = system.window(seconds, trace)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    found = devlib.forbidden_modules()
    if found:
        print(f"run: modules of JAX or the JAX package are loaded: {found}",
              file=sys.stderr)
        sys.exit(4)
    run = Run(system, record, setup_s)

    metrics = {}
    for m in (cell.per_layer() if trace else cell.end_to_end()):
        value = cell.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    system.release()
    modes = system.modes()
    numbers = system.compare(system.answers(),
                             system.reference(modes["stated"]))
    checks = {name: {"value": numbers[name], "limit": limit}
              for name, limit in cell.limits["limits"].items()}
    correct = all(_number(c["value"]) is not None
                  and c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": correct, "attempted": record["attempted"],
              "failed": record["failed"], "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda"
                         else device.type,
                         "kind": (torch.cuda.get_device_name(device)
                                  if device.type == "cuda" else "cpu"),
                         "count": cell.chips,
                         "memory_peak_bytes": peak}}
    if trace and system.trace is not None:
        result["device"]["busy_s"] = system.trace.busy_s
        result["device"]["window_s"] = system.trace.window_s
        result["breakdown"] = system.trace.breakdown()
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.load(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"run: {args.workload} needs {cell.chips} CUDA device(s), "
              f"found {have}", file=sys.stderr)
        return 3
    print(f"nvidia-smi: {devlib.nvidia_smi()}", file=sys.stderr, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"cell {args.workload} seed {args.seed} seconds {args.seconds} "
          f"trace {args.trace}", file=sys.stderr, flush=True)
    result = execute(cell, args.seed, args.seconds, bool(args.trace),
                     "cuda:0")
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

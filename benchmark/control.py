#!/usr/bin/env python3
"""Readings that set a cell's correctness limits, on the chip.

    python3 benchmark/control.py --workload CELL --seeds 1,2,... \
        [--control-seeds 1,2,3] [--seconds S] [--out FILE]

For every seed, in one process: the cell's set-up and an S-second window
(a search cell's check includes a step of the window, so S > 0 there), then
the numbers the run compares (the program against the reference in the
configuration's precision: the lower reading).  For each control seed also the control's
numbers (the reference in the next lower precision, in the program's
place: TF32 for float32, fp8 for bfloat16) and, for a search cell, the
fault that leaves half of each batch out (the reference on the first half
of the rows, in the program's place), in the first steps and in the kept
window step alike.  One JSON line per seed on standard
output and in FILE, then the largest program reading and the smallest
control and fault readings of each number.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.lib import device as devlib  # noqa: E402

devlib.cache_env(ROOT)

import torch  # noqa: E402

from benchmark.lib import spec  # noqa: E402


def readings(cell, seed: int, seconds: float, control: bool, device) -> dict:
    system = cell.system().System(cell, seed, device)
    t0 = time.perf_counter()
    with system.context():
        system.setup()
        system.window(seconds, False)
    system.release()
    modes = system.modes()
    ref = system.reference(modes["stated"])
    out = {"seed": seed,
           "program": system.compare(system.answers(), ref)}
    if control:
        out["control"] = system.compare(system.reference(modes["control"]),
                                        ref)
        if cell.config["system"] == "search":
            half = cell.traffic["batch"] // 2
            out["half_batch"] = system.compare(
                system.reference(modes["stated"], batch_rows=half), ref)
    out["seconds"] = time.perf_counter() - t0
    del system
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: CUDA is not available", file=sys.stderr)
        return 3
    print(f"nvidia-smi: {devlib.nvidia_smi()}", flush=True)
    cell = spec.load(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    rows = []
    sink = open(args.out, "a") if args.out else None
    try:
        for seed in seeds:
            row = readings(cell, seed, args.seconds, seed in controls,
                           torch.device("cuda:0"))
            rows.append(row)
            line = json.dumps({"workload": args.workload, **row})
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    finally:
        if sink:
            sink.close()
    summary = {"workload": args.workload, "seeds": len(rows)}
    for kind, pick in (("program", max), ("control", min),
                       ("half_batch", min)):
        got = [r[kind] for r in rows if kind in r]
        if got:
            summary[kind] = {k: pick(g[k] for g in got) for k in got[0]}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Repeated runs of one cell, one process each, and their spread.

    python3 benchmark/sets.py --workload CELL --seeds 11,12,... \
        --out DIR [--sets 2] [--seconds S] [--trace-seeds 21,22]

Runs benchmark/run.py for each seed in turn, once in each set before the
next seed (so both sets have the same seeds, and a drift of the machine's
speed over the call reaches both sets alike), then once with --trace 1 for
each trace seed.  Keeps each run's result line and the end of its standard error in
DIR/<cell>.jsonl, and prints for each end-to-end metric and set the median,
the quartiles (statistics.quantiles, n=4) and the spread, the distance
between the quartiles over the median.  S defaults to BENCHMARK.json's
run_seconds.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def one(cell: str, seed: int, seconds: float, trace: int) -> dict:
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
         cell, "--seed", str(seed), "--seconds", str(seconds), "--trace",
         str(trace)], cwd=ROOT, capture_output=True, text=True)
    lines = proc.stdout.strip().splitlines()
    try:
        result = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        result = None
    return {"seed": seed, "trace": trace, "rc": proc.returncode,
            "wall_s": time.perf_counter() - t0, "result": result,
            "stderr_tail": proc.stderr[-3000:]}


def spread(values: list) -> dict:
    q1, q2, q3 = statistics.quantiles(values, n=4)
    med = statistics.median(values)
    return {"median": med, "q1": q1, "q3": q3,
            "spread": (q3 - q1) / med if med else float("nan"),
            "values": values}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--trace-seeds", default="")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    seconds = args.seconds or json.loads(
        (ROOT / "BENCHMARK.json").read_text())["run_seconds"]
    seeds = [int(s) for s in args.seeds.split(",")]
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    sink = out / f"{args.workload}.jsonl"
    runs = []
    plan = [(k, s, 0) for s in seeds for k in range(args.sets)]
    plan += [(None, int(s), 1) for s in args.trace_seeds.split(",") if s]
    for k, seed, trace in plan:
        row = {"set": k, **one(args.workload, seed, seconds, trace)}
        runs.append(row)
        with open(sink, "a") as f:
            f.write(json.dumps(row) + "\n")
        res = row["result"] or {}
        print(json.dumps({"set": k, "seed": seed, "trace": trace,
                          "rc": row["rc"], "wall_s": round(row["wall_s"], 1),
                          "correct": res.get("correct"),
                          "metrics": {m: v["value"] for m, v in
                                      res.get("metrics", {}).items()},
                          "checks": {c: v["value"] for c, v in
                                     res.get("checks", {}).items()},
                          "peak": res.get("device", {}).get(
                              "memory_peak_bytes")}), flush=True)
        if row["rc"] != 0:
            print(row["stderr_tail"], flush=True)
    for k in range(args.sets):
        got = [r["result"] for r in runs if r["set"] == k and r["result"]]
        names = sorted({m for g in got for m in g["metrics"]})
        for m in names:
            values = [g["metrics"][m]["value"] for g in got
                      if m in g["metrics"]]
            if len(values) >= 2:
                print(json.dumps({"set": k, "metric": m, **spread(values)}),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

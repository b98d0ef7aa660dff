"""What the darts_ft decode costs in native PSNR, on the planted workload.

Counterpart of the repo's tools/ft_divergence.py, on the GPU unless
`--device cpu` is given.  In ft mode only the ft-flagged ops (reinhard,
crysis, filmic, whiteworld, bilateral, median, fastnlm, bm3d) run through
SRCNN proxies, tuned toward their native op every `ft_interval` steps on
the search's own intermediates; between tuning rounds a proxy keeps
expressive slack, and the alphas are optimised against the proxy-world
loss, so the ft leg may decode a different sRGB family from the native leg.
For every seed in <out>/results.json (tools/planted_demo.py's file) this
trains each leg's decoded architecture natively in step 2 (the margin
table's config and budget) and takes its held-out PSNR: written back under
seeds.<s>.leg_arch_psnr, with the top-level ft_divergence_psnr_gap_db
(ft_gap).

Usage: python -m reconfigisp_tpu_torch.tools.ft_divergence [--isp-iters N]
       [--seeds 0,1,2] [--out DIR] [--device cpu] [--eval-frames N]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from reconfigisp_tpu_torch.device import resolve_device
from reconfigisp_tpu_torch.tools.planted_demo import (
    LEGS, OUT_DIR, _dump, log, step2_record, train_fixed)

NOTE = ("native-arch PSNR minus ft-arch PSNR after identical native step-2 "
        "training; positive = the ft decode costs quality in the native "
        "world (proxy-slack bias, see tools/ft_divergence.py docstring)")


def ft_gap(results: dict, seeds) -> dict:
    """Per seed, the native leg's held-out PSNR minus the ft leg's, and
    their mean -> the ft_divergence_psnr_gap_db entry, or None where no
    seed has both."""
    gaps = {}
    for s in seeds:
        t = results["seeds"][s].get("leg_arch_psnr", {})
        if "native" in t and "ft" in t:
            gaps[s] = round(t["native"]["psnr"] - t["ft"]["psnr"], 3)
    if not gaps:
        return None
    return {"per_seed": gaps,
            "mean": round(float(np.mean(list(gaps.values()))), 3),
            "note": NOTE}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--isp-iters", type=int, default=700)
    ap.add_argument("--seeds", default=None,
                    help="subset of seeds (default: all in the file)")
    ap.add_argument("--eval-frames", type=int, default=16,
                    help="held-out frames of each PSNR")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rpath = os.path.join(args.out, "results.json")
    proxies = os.path.join(args.out, "proxies.ckpt")
    with open(rpath) as f:
        results = json.load(f)
    seeds = (args.seeds.split(",") if args.seeds
             else sorted(results.get("seeds", {})))

    for s in seeds:
        res = results["seeds"][s]
        table = res.get("leg_arch_psnr", {})
        for leg, _ in LEGS:
            arch = (res.get(f"search_{leg}") or {}).get("architecture")
            if not arch:
                continue
            if table.get(leg, {}).get("architecture") == arch:
                log(f"seed {s}: reusing cached {leg} arch eval")
                continue
            log(f"seed {s}: step-2 training {leg} arch {arch} "
                f"({args.isp_iters} iters)")
            pipe, logs = train_fixed(arch, args.isp_iters, seed=int(s),
                                     proxies=proxies, device=dev)
            table[leg] = step2_record(arch, pipe, logs, args.eval_frames)
            log(f"  seed {s} {leg}: {table[leg]['psnr']:.2f} dB")
            res["leg_arch_psnr"] = table
            _dump(results, rpath)

    gap = ft_gap(results, seeds)
    if gap:
        results["ft_divergence_psnr_gap_db"] = gap
        _dump(results, rpath)
        log(f"ft divergence gap (native - ft, dB): {gap['per_seed']} "
            f"mean {gap['mean']}")


if __name__ == "__main__":
    main()

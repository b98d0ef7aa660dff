"""The planted proxy leg from the module bank, in either package, and the
alphas of two such runs compared.

configs/planted_search_proxy.yaml as written (1,500 second-order steps of
4 x 48² through the proxies), its proxies the bank
experiments/proxies/default.ckpt, which both packages read, logged every
`--print-freq` steps and checkpointed every 50.  The JAX package runs on
the CPU at "highest" matmul precision (about 7 s a step on six cores); the
port on the CPU or the card, TF32 on (torch's default, as the tools run)
or off.  Not a test: a helper beside the tests, which alone import both
packages.

    python tests/compare_proxy_leg.py run jax OUT [--iters N]
    python tests/compare_proxy_leg.py run port OUT [--device cuda] [--tf32 off]
    python tests/compare_proxy_leg.py diff OUT_A OUT_B --steps 50,100
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import yaml

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
BANK = REPO / "experiments" / "proxies" / "default.ckpt"
NAME = "planted_search_proxy"


def options(print_freq: int) -> dict:
    raw = yaml.safe_load((REPO / "configs" / f"{NAME}.yaml").read_text())
    raw["path"]["pretrain_proxies"] = str(BANK)
    raw["logger"].update(print_freq=print_freq, save_checkpoint_freq=50)
    raw["train"]["resume"] = False
    return raw


def run(pkg: str, out: str, iters: int, device: str, tf32: bool,
        print_freq: int) -> dict:
    raw = options(print_freq)
    if pkg == "jax":
        import jax
        from reconfigisp_tpu import config
        from reconfigisp_tpu.search.trainer import run_training
        with jax.default_matmul_precision("highest"):
            return run_training(config.parse_dict(raw, root=out),
                                max_iters=iters)
    import torch
    from reconfigisp_tpu_torch import config
    from reconfigisp_tpu_torch.search.trainer import run_training
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    return run_training(config.parse_dict(raw, root=out), max_iters=iters,
                        device=device)


def diff(a: str, b: str, steps: list) -> None:
    from reconfigisp_tpu_torch.utils.checkpoint import load_network
    for step in steps:
        x, y = (load_network(os.path.join(
            d, "experiments", NAME, "models", f"{step}_G.ckpt"))
            for d in (a, b))
        alphas = max(float(np.abs(np.asarray(x["alphas"][k])
                                  - np.asarray(y["alphas"][k])).max())
                     for k in x["alphas"])
        theta = max(float(np.abs(np.asarray(v) - np.asarray(
            y["theta"][slot][op])).max())
            for slot, ops in x["theta"].items() for op, v in ops.items())
        print(f"step {step}: alphas {alphas:.3e} theta {theta:.3e} "
              f"demosaic {np.round(np.asarray(x['alphas']['demosaic']), 3)}"
              f" / {np.round(np.asarray(y['alphas']['demosaic']), 3)}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("pkg", choices=("jax", "port"))
    r.add_argument("out")
    r.add_argument("--iters", type=int, default=1500)
    r.add_argument("--device", default="cpu")
    r.add_argument("--tf32", choices=("on", "off"), default="on")
    r.add_argument("--print-freq", type=int, default=10)
    d = sub.add_parser("diff")
    d.add_argument("a")
    d.add_argument("b")
    d.add_argument("--steps", default="50,100")
    args = ap.parse_args()
    if args.cmd == "diff":
        diff(args.a, args.b, [int(s) for s in args.steps.split(",")])
        return
    t0 = time.time()
    summary = run(args.pkg, args.out, args.iters, args.device,
                  args.tf32 == "on", args.print_freq)
    print("SUMMARY", json.dumps(
        {k: v for k, v in summary.items()
         if isinstance(v, (int, float, str))}), f"{time.time() - t0:.0f} s",
        flush=True)


if __name__ == "__main__":
    main()

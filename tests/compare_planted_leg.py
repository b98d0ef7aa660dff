"""A planted search leg from the module bank, in either package, and the
alphas and theta of two such runs compared.

The leg's config as written (configs/planted_search.yaml for `native`,
planted_search_proxy.yaml for `proxy`, planted_search_ft.yaml for `ft`:
1,500 second-order steps of 4 x 48²), its proxies the bank
experiments/proxies/default.ckpt, which both packages read, logged every
`--print-freq` steps and checkpointed every 50.  `--seed N` offsets
`manual_seed` by N and, past seed 0, names the experiment
`<name>_seed<N>`, as both packages' planted demo does.  The JAX package
runs on the CPU at "highest" matmul precision (about 7 s a proxy step on
six cores); the port on the CPU or the card, TF32 on (torch's default, as
the tools run) or off.  Not a test: a helper beside the tests, which alone
import both packages.

    python tests/compare_planted_leg.py run jax OUT [--seed N] [--leg L]
        [--iters N] [--jit ops]
    python tests/compare_planted_leg.py run port OUT [--seed N] [--leg L]
        [--device cuda] [--tf32 off]
    python tests/compare_planted_leg.py diff OUT_A OUT_B [--seed N]
        [--leg L] --steps 50,100
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
CONFIGS = {"native": "planted_search", "proxy": "planted_search_proxy",
           "ft": "planted_search_ft"}


def name(leg: str, seed: int) -> str:
    """The leg's experiment name under `seed`, as the planted demo's."""
    return CONFIGS[leg] + (f"_seed{seed}" if seed else "")


def options(leg: str, seed: int, print_freq: int) -> dict:
    raw = yaml.safe_load(
        (REPO / "configs" / f"{CONFIGS[leg]}.yaml").read_text())
    raw["name"] = name(leg, seed)
    raw["path"]["pretrain_proxies"] = str(BANK)
    raw["logger"].update(print_freq=print_freq, save_checkpoint_freq=50)
    raw["train"]["resume"] = False
    return raw


def _seeded(opt: dict, seed: int) -> dict:
    opt["train"]["manual_seed"] = (opt["train"].get("manual_seed") or 0) + seed
    return opt


def _eager_steps(trainer) -> None:
    """The JAX trainers' steps run eagerly over a supernet whose ops are
    each jitted (test_torch_supernet.jit_ops), as the CPU tests run them:
    a jit of the native supernet's whole step does not finish compiling on
    the CPU within an hour."""
    import types
    from test_torch_supernet import jit_ops
    jax = trainer.jax
    trainer.jax = types.SimpleNamespace(
        **{k: getattr(jax, k) for k in dir(jax) if not k.startswith("__")})
    trainer.jax.jit = lambda fn, **kw: fn
    net = trainer.SuperNet
    trainer.SuperNet = lambda *a, **kw: jit_ops(net(*a, **kw))


def run(pkg: str, out: str, leg: str, seed: int, iters: int, device: str,
        tf32: bool, print_freq: int, jit: str = "step") -> dict:
    raw = options(leg, seed, print_freq)
    if pkg == "jax":
        import jax
        from reconfigisp_tpu import config
        from reconfigisp_tpu.search import trainer
        if jit == "ops":
            _eager_steps(trainer)
        with jax.default_matmul_precision("highest"):
            return trainer.run_training(
                _seeded(config.parse_dict(raw, root=out), seed),
                max_iters=iters)
    import torch
    from reconfigisp_tpu_torch import config
    from reconfigisp_tpu_torch.search.trainer import run_training
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    return run_training(_seeded(config.parse_dict(raw, root=out), seed),
                        max_iters=iters, device=device)


def diff(a: str, b: str, leg: str, seed: int, steps: list) -> None:
    from reconfigisp_tpu_torch.utils.checkpoint import load_network
    for step in steps:
        x, y = (load_network(os.path.join(
            d, "experiments", name(leg, seed), "models", f"{step}_G.ckpt"))
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
    r.add_argument("--jit", choices=("step", "ops"), default="step",
                   help="JAX: jit each step whole (as the JAX package "
                        "runs) or each op of an eager step")
    d = sub.add_parser("diff")
    d.add_argument("a")
    d.add_argument("b")
    d.add_argument("--steps", default="50,100")
    for p in (r, d):
        p.add_argument("--seed", type=int, default=0)
        p.add_argument("--leg", choices=tuple(CONFIGS), default="proxy")
    args = ap.parse_args()
    if args.cmd == "diff":
        diff(args.a, args.b, args.leg, args.seed,
             [int(s) for s in args.steps.split(",")])
        return
    t0 = time.time()
    summary = run(args.pkg, args.out, args.leg, args.seed, args.iters,
                  args.device, args.tf32 == "on", args.print_freq, args.jit)
    print("SUMMARY", json.dumps(
        {k: v for k, v in summary.items()
         if isinstance(v, (int, float, str))}), f"{time.time() - t0:.0f} s",
        flush=True)


if __name__ == "__main__":
    main()

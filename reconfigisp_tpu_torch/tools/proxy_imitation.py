"""How well each proxy of a module checkpoint imitates its native op, on
held-out samples: what the proxies show a proxy-mode search.

For every sRGB and demosaic proxy the checkpoints hold, the mean l2 between
the proxy's output and its target (the native op; BM3D's is
ops/denoise.dct_denoise) over `--batches` batches of search/proxy_pretrain's
plans, drawn from a held-out seed (the pretraining draws from seed 0).  One
column a checkpoint, e.g. the module bank against a checkpoint the port's
pretraining wrote; the table goes to stdout and, with --out, as JSON.

Usage:  python -m reconfigisp_tpu_torch.tools.proxy_imitation CKPT [CKPT ...]
        [--batches N] [--seed S] [--device cpu] [--out FILE]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from reconfigisp_tpu_torch import convert
from reconfigisp_tpu_torch.device import resolve_device
from reconfigisp_tpu_torch.registry import pool
from reconfigisp_tpu_torch.search.proxy_pretrain import make_plans
from reconfigisp_tpu_torch.utils import checkpoint, losses


def proxy_names() -> set:
    """The ops a proxy-mode search sees through a proxy."""
    names = {s.name for s in pool("srgb")
             if s.proxy_apply is not None and s.ft_target_fn() is not None}
    return names | {s.name for s in pool("demosaic")
                    if s.proxy_apply is not None and s.apply is not None}


@torch.no_grad()
def imitation_errors(ckpt: str, batches: int = 8, seed: int = 99,
                     batch: int = 8, size: int = 48, device=None) -> dict:
    """{proxy name: mean l2 against its target over `batches` held-out
    batches} for the proxies `ckpt` holds."""
    dev = resolve_device(device)
    bank = checkpoint.load_network(ckpt)
    names = proxy_names()
    out = {}
    plans = make_plans(batch, size, seed, 0.05, np.random.default_rng(seed))
    for plan in plans:
        if plan.name not in names or plan.name not in bank:
            continue
        module = plan.init(torch.Generator().manual_seed(0))
        module.load_state_dict(convert.weights_from_jax(bank[plan.name]))
        module = module.to(dev).eval()
        errs = []
        for i in range(batches):
            x, params, _ = plan.sample(i)
            x = torch.from_numpy(np.asarray(x, np.float32)).to(dev)
            params = None if params is None else torch.from_numpy(
                np.asarray(params, np.float32)).to(dev)
            target = plan.target(x, params)
            errs.append(float(losses.l2(plan.apply(x, params, module),
                                        target)))
        out[plan.name] = float(np.mean(errs))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("ckpts", nargs="+")
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--seed", type=int, default=99,
                    help="held-out draws (pretraining draws from 0)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    table = {c: imitation_errors(c, args.batches, args.seed,
                                 device=args.device) for c in args.ckpts}
    names = sorted(set().union(*table.values()))
    print("proxy " + " ".join(args.ckpts))
    for name in names:
        print(name + " " + " ".join(
            f"{table[c][name]:.4e}" if name in table[c] else "-"
            for c in args.ckpts))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"seed": args.seed, "batches": args.batches,
                       "l2": table}, f, indent=1)


if __name__ == "__main__":
    main()

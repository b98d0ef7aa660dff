"""The full two-step ReconfigISP method on the planted-pipeline workload.

Counterpart of the repo's tools/planted_demo.py, on the GPU unless
`--device cpu` is given.  The planted workload
(data/datasets.SyntheticPlantedDataset) generates its GT with a known
pipeline, path-denoise -> Malvar -> wbmanual(cast^-1) -> gamma(1/2.2), under
heavy shot noise and a colour cast, so the search has a ground-truth
architecture to recover.  The tool runs:

  0. module pretraining (search/proxy_pretrain) -> <out>/proxies.ckpt
  1. native-op DARTS search        (configs/planted_search.yaml)
  2. proxy-parity DARTS search     (configs/planted_search_proxy.yaml)
  2b. online proxy-tuning search   (configs/planted_search_ft.yaml, model
      darts_ft)
  3. step-2 fixed training of the searched architecture and of every
     single-op ablation (denoise -> skip, demosaic -> nearest, each sRGB
     step -> skip, deduplicated by the executed program)
  4. held-out PSNR of every trained pipeline

and writes <out>/results.json with the JAX tool's keys, and the device's
name and power limit under "device".  The searches' experiment trees go
under <out>/experiments/, so they never mix with a JAX run's; a leg whose
recorded result is finite and complete is reused, as is a step-2 result of
the same architecture.  The native and ft legs run the 15-op sRGB slots,
which hold the bilateral, median and fast-NLM ops: on the card every search
step launches the three kernels.

Usage:  python -m reconfigisp_tpu_torch.tools.planted_demo [--fast]
        [--skip-pretrain] [--seeds 0,1,2] [--search-iters N]
        [--isp-iters N] [--out DIR] [--device cpu]
  --fast shrinks the budgets about 10x.  --pretrain-steps, --ft-interval
  and --eval-frames override the pretraining steps, darts_ft's tuning
  interval and the held-out frames (16) for smoke runs.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
import yaml

from reconfigisp_tpu_torch import config
from reconfigisp_tpu_torch.data import create_loader
from reconfigisp_tpu_torch.data.datasets import SyntheticPlantedDataset
from reconfigisp_tpu_torch.device import resolve_device
from reconfigisp_tpu_torch.pipeline import Pipeline, parse_architecture
from reconfigisp_tpu_torch.search.trainer import IspTrainer, run_training
from reconfigisp_tpu_torch.tools import CONFIGS, device_record
from reconfigisp_tpu_torch.utils import checkpoint
from reconfigisp_tpu_torch.utils.metrics import psnr as psnr_fn

OUT_DIR = os.path.join("experiments", "planted_torch")
LEGS = (("native", "planted_search.yaml"),
        ("proxy", "planted_search_proxy.yaml"),
        ("ft", "planted_search_ft.yaml"))


def log(*a):
    print("[planted_demo]", *a, flush=True)


def _finite(x) -> bool:
    try:
        return x is not None and np.isfinite(float(x))
    except (TypeError, ValueError):
        return False


def _sanitize(o):
    """Non-finite floats -> None, so the file is strict JSON."""
    if isinstance(o, dict):
        return {k: _sanitize(v) for k, v in o.items()}
    if isinstance(o, list):
        return [_sanitize(v) for v in o]
    if isinstance(o, float) and not np.isfinite(o):
        return None
    return o


def _dump(obj, path):
    with open(path, "w") as f:
        json.dump(_sanitize(obj), f, indent=1, allow_nan=False)


@torch.no_grad()
def eval_psnr(pipe: Pipeline, n: int = 16, size: int = 128,
              seed: int = 99) -> float:
    """Held-out PSNR of a trained pipeline on fresh planted frames, on the
    pipeline's device."""
    ds = SyntheticPlantedDataset(n=n, size=size, seed=seed)
    vals = []
    for i in range(n):
        s = ds[i]
        y = pipe(torch.from_numpy(s["noisy"])[None].to(pipe.device))
        gt = torch.from_numpy(s["gt"])[None].to(pipe.device)
        vals.append(float(psnr_fn(y, gt)[0]))
    return float(np.mean(vals))


def train_fixed(arch: str, niter: int, *, use_proxy: bool = False,
                seed: int = 0, proxies=None, device=None) -> tuple:
    """Step-2 training of a fixed architecture through
    configs/planted_isp.yaml, the architecture overridden, the module
    weights from `proxies` where that file exists -> (trained Pipeline, the
    last step's logs, with the loss on the first batch before and after,
    probe_loss_start and probe_loss_final, and the largest move of a logit,
    logits_moved: 0 where no parameter gets a gradient, as whiteworld's
    quantile and the median's radius do not)."""
    opt = config.parse(str(CONFIGS / "planted_isp.yaml"), is_train=True)
    opt["network_G"]["architecture"] = arch
    opt["network_G"]["use_proxy"] = use_proxy
    train_opt = opt["train"]
    ds = SyntheticPlantedDataset(
        n=64, size=96, seed=(train_opt.get("manual_seed", 10) or 10) + seed)
    pipe = Pipeline(arch, use_proxy=use_proxy, device=resolve_device(device),
                    generator=torch.Generator().manual_seed(seed))
    tr = IspTrainer(pipe, train_opt,
                    train_weights=bool(train_opt.get("train_weights")))
    if proxies and os.path.exists(proxies):
        loaded = checkpoint.load_network(proxies)
        tr.load_weights({name: w for name, w in loaded.items()
                         if name in pipe.weights})
    loader = iter(create_loader(ds, 4))
    init = {k: v.detach().clone() for k, v in pipe.logits.items()}
    logs = {}
    first = None
    t0 = time.time()
    for i in range(niter):
        batch = next(loader)
        if first is None:
            first, start = batch, tr.eval_loss(batch)
        logs = tr.train_step(batch)
        if (i + 1) % 200 == 0:
            log(f"  [{arch}] iter {i + 1}/{niter} loss {logs['loss']:.3e} "
                f"({(time.time() - t0) / (i + 1):.3f}s/iter)")
    if first is not None:
        logs.update(probe_loss_start=start,
                    probe_loss_final=tr.eval_loss(first))
    logs["logits_moved"] = max(
        (float((v.detach() - init[k]).abs().max())
         for k, v in pipe.logits.items()), default=0.0)
    return tr.pipeline, logs


def step2_record(arch: str, pipe: Pipeline, logs: dict,
                 eval_frames: int = 16) -> dict:
    """A step-2 result: the JAX tool's architecture, final train loss and
    held-out PSNR, and train_fixed's probe losses and logits_moved."""
    return {"architecture": arch,
            "train_loss": float(logs.get("loss", np.nan)),
            "psnr": eval_psnr(pipe, n=eval_frames),
            **{k: logs[k] for k in ("probe_loss_start", "probe_loss_final",
                                    "logits_moved") if k in logs}}


def ablations_of(arch: str) -> dict:
    """Single-op ablations of a searched architecture, deduplicated by the
    executed pipeline: sRGB op 10 is a parameterless identity, so
    candidates whose skip-stripped step sequences match are one program
    (with sRGB_13_13_13, skipping any one copy executes 13_13)."""
    steps = parse_architecture(arch)

    def canon(seq):
        return tuple(s for s in seq if s != ("srgb", 10))

    out = {}
    seen = set()
    out["no_denoise"] = _format([("bayer", 2)] + steps[1:])
    out["nearest_demosaic"] = _format(
        [steps[0], ("demosaic", 1)] + steps[2:])
    for i, (dom, idx) in enumerate(steps):
        if dom == "srgb" and idx != 10:
            abl = steps[:i] + [("srgb", 10)] + steps[i + 1:]
            if canon(abl) in seen:
                continue
            seen.add(canon(abl))
            out[f"drop_srgb_step{i}"] = _format(abl)
    return out


def _format(steps) -> str:
    parts = []
    last_dom = None
    for dom, idx in steps:
        tok = {"bayer": "Bayer", "demosaic": "Demosaic", "srgb": "sRGB"}[dom]
        if dom != last_dom:
            parts.append(tok)
            last_dom = dom
        parts.append(f"{idx:02d}")
    return "_".join(parts)


def _search_options(cfg: str, seed: int, out: str, proxies: str,
                    rerun: bool, ft_interval) -> dict:
    """A search leg's options: the config as written, rooted at `out`, its
    proxies at `proxies`; a per-seed experiment name past seed 0 (else a
    later seed resumes the earlier one's checkpointed run); a fresh run
    where a completed leg is re-run (else it resumes at max_iters and
    runs nothing)."""
    with open(CONFIGS / cfg) as f:
        raw = yaml.safe_load(f)
    if rerun:
        raw.setdefault("train", {})["resume"] = False
    if seed != 0:
        raw["name"] = f"{raw['name']}_seed{seed}"
    raw.setdefault("path", {})["pretrain_proxies"] = proxies
    if ft_interval and raw.get("proxy_ft_params"):
        raw["proxy_ft_params"]["ft_interval"] = int(ft_interval)
    opt = config.parse_dict(raw, is_train=True, root=out)
    opt["train"]["manual_seed"] = (opt["train"].get("manual_seed") or 0) + seed
    return opt


def run_one_seed(seed: int, search_iters: int, isp_iters: int,
                 prior: dict, save, *, out: str = OUT_DIR, device=None,
                 ft_interval=None, eval_frames: int = 16) -> dict:
    """One demo pass under `seed` (it offsets the search's and step 2's
    seeds; the planted pipeline is fixed): three search legs, step-2
    training of the searched architecture and its ablations, held-out PSNR,
    margin.  `save(res)` is called after each leg and training."""
    proxies = os.path.join(out, "proxies.ckpt")
    res = dict(prior)
    for leg, cfg in LEGS:
        cached = res.get(f"search_{leg}", {})
        complete = (cached.get("iters") or 0) >= search_iters
        if complete:
            # a non-finite cached leg is no evidence: run it again
            if _finite(cached.get("loss")) and _finite(cached.get("val_loss")):
                log(f"seed {seed}: reusing cached {leg} search "
                    f"({cached['iters']} iters)")
                continue
            log(f"seed {seed}: cached {leg} search has non-finite metrics "
                f"-> re-running")
        log(f"seed {seed}: {leg} search ({search_iters} iters)...")
        opt = _search_options(cfg, seed, out, proxies, complete, ft_interval)
        t0 = time.time()
        summary = run_training(opt, max_iters=search_iters, device=device)
        if (summary.get("steps_run") == 0 and _finite(cached.get("loss"))
                and not _finite(summary.get("loss"))):
            # a resume already at max_iters never overwrites a finite result
            log(f"seed {seed}: {leg} search resumed already-complete with "
                f"no metrics — keeping the recorded finite result")
            continue
        res[f"search_{leg}"] = {
            "architecture": summary["architecture"],
            "loss": summary.get("loss"),
            "val_loss": summary.get("val_loss"),
            "iters": search_iters,
            "seconds": round(time.time() - t0, 1),
        }
        log(f"seed {seed}: {leg} search -> {summary['architecture']} "
            f"({res[f'search_{leg}']['seconds']}s)")
        save(res)

    arch = res["search_native"]["architecture"]
    candidates = {"searched": arch, **ablations_of(arch)}
    # cached entries of another searched architecture's candidates go
    psnrs = {k: v for k, v in res.get("step2_psnr", {}).items()
             if k in candidates}
    for name, a in candidates.items():
        if psnrs.get(name, {}).get("architecture") == a:
            continue
        log(f"seed {seed}: step-2 training {name}: {a} ({isp_iters} iters)")
        pipe, logs = train_fixed(a, isp_iters, seed=seed, proxies=proxies,
                                 device=device)
        psnrs[name] = step2_record(a, pipe, logs, eval_frames)
        log(f"  seed {seed} {name}: held-out PSNR "
            f"{psnrs[name]['psnr']:.2f} dB")
        res["step2_psnr"] = psnrs
        save(res)
    res["step2_psnr"] = psnrs

    searched = psnrs["searched"]["psnr"]
    best_abl = max(v["psnr"] for k, v in psnrs.items() if k != "searched")
    res["margin_db"] = round(searched - best_abl, 3)
    res["planted_recovered"] = {
        "bayer_is_denoise": arch.startswith("Bayer_01"),
        "demosaic_is_highquality": ("_Demosaic_03" in arch
                                    or "_Demosaic_04" in arch),
    }
    save(res)
    log(f"seed {seed}: searched {searched:.2f} dB vs best ablation "
        f"{best_abl:.2f} dB (margin {res['margin_db']:+.2f} dB)")
    return res


def _planted(a: str) -> bool:
    """The planted ops: path-denoise and a Malvar-class demosaic."""
    return a.startswith("Bayer_01") and (
        "_Demosaic_03" in a or "_Demosaic_04" in a)


def aggregate(results: dict, seeds: list) -> bool:
    """Cross-seed aggregates over the seeds that have finished, into
    `results` (the first seed's run also as flat top-level keys) -> whether
    any seed has finished."""
    done = [results["seeds"][str(s)] for s in seeds
            if "margin_db" in results["seeds"].get(str(s), {})]
    if not done:
        return False
    margins = [r["margin_db"] for r in done]
    # every seed that searched, finished or not
    archs = sorted({r["search_native"]["architecture"]
                    for r in results["seeds"].values()
                    if "search_native" in r})
    results["seeds_finished"] = len(done)
    results["seeds_pending"] = len(seeds) - len(done)
    if str(seeds[0]) in results["seeds"]:
        results.update(results["seeds"][str(seeds[0])])
    results["margin_db_per_seed"] = {
        str(s): results["seeds"][str(s)].get("margin_db")
        for s in seeds if str(s) in results["seeds"]}
    results["margin_db_mean"] = round(float(np.mean(margins)), 3)
    results["margin_db_std"] = round(float(np.std(margins)), 3)
    results["native_archs_across_seeds"] = archs
    legs = [leg for leg, _ in LEGS]
    with_ft = [s for s in seeds
               if "search_ft" in results["seeds"].get(str(s), {})]
    results["all_legs_agree_per_seed"] = {
        str(s): len({results["seeds"][str(s)][f"search_{leg}"]
                     ["architecture"] for leg in legs}) == 1
        for s in with_ft}
    # the trailing sRGB steps commute and may differ across legs
    results["all_legs_recover_planted_per_seed"] = {
        str(s): all(_planted(results["seeds"][str(s)][f"search_{leg}"]
                             ["architecture"]) for leg in legs)
        for s in with_ft}
    return True


def pretrain(path: str, steps: int, device=None) -> None:
    """Step 0: every learned module pretrained -> `path`."""
    from reconfigisp_tpu_torch.search.proxy_pretrain import pretrain_modules
    log(f"pretraining modules ({steps} steps)...")
    trained = pretrain_modules(steps=steps, noise_std=0.05, log_every=500,
                               device=device)
    d, fn = os.path.split(path)
    src = checkpoint.save_network(d, "proxies", fn.replace(".ckpt", ""),
                                  trained)
    os.replace(src, path)
    log(f"saved {sorted(trained)} -> {path}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--skip-pretrain", action="store_true")
    ap.add_argument("--seeds", default="0,1,2",
                    help="comma-separated seed sweep; the margin is "
                         "reported as mean and std across seeds")
    ap.add_argument("--search-iters", type=int, default=None,
                    help="override the per-leg search budget (cached legs "
                         "with >= this many iters are reused)")
    ap.add_argument("--isp-iters", type=int, default=None,
                    help="override the step-2 fixed-training budget")
    ap.add_argument("--pretrain-steps", type=int, default=None,
                    help="override the module pretraining steps")
    ap.add_argument("--ft-interval", type=int, default=None,
                    help="override darts_ft's proxy-tuning interval")
    ap.add_argument("--eval-frames", type=int, default=16,
                    help="held-out frames of each PSNR")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    out = args.out
    os.makedirs(out, exist_ok=True)
    proxies = os.path.join(out, "proxies.ckpt")
    rpath = os.path.join(out, "results.json")
    results = {}
    if os.path.exists(rpath):
        with open(rpath) as f:
            results = json.load(f)
    results.setdefault("seeds", {})
    results["device"] = device_record(dev)

    scale = 0.1 if args.fast else 1.0
    pre_steps = args.pretrain_steps or max(int(3000 * scale), 200)
    search_iters = args.search_iters or max(int(1500 * scale), 60)
    isp_iters = args.isp_iters or max(int(800 * scale), 60)

    # step 0, shared across seeds like the reference's pretrained bank
    if not args.skip_pretrain and not os.path.exists(proxies):
        pretrain(proxies, pre_steps, dev)

    seeds = [int(s) for s in args.seeds.split(",") if s != ""]
    for seed in seeds:
        skey = str(seed)

        def save(res, skey=skey):
            results["seeds"][skey] = res
            _dump(results, rpath)

        prior = results["seeds"].get(skey, {})
        results["seeds"][skey] = run_one_seed(
            seed, search_iters, isp_iters, prior, save, out=out, device=dev,
            ft_interval=args.ft_interval, eval_frames=args.eval_frames)
        if aggregate(results, seeds):
            _dump(results, rpath)
            log(f"margins per seed: {results['margin_db_per_seed']} -> "
                f"{results['margin_db_mean']} ± "
                f"{results['margin_db_std']} dB; native archs across seeds: "
                f"{results['native_archs_across_seeds']}")


if __name__ == "__main__":
    main()

"""Offline pretraining of every learned module of the search space (step 0).

Counterpart of reconfigisp_tpu/search/proxy_pretrain.py (the reference loads
12 pretrained proxy checkpoints at supernet construction,
super_prune...py:34-47, and per-step weights for fixed pipelines,
isp_universal.py:169-176):

  * sRGB proxies: SRCNN-Res imitators trained against the native op on
    params ~ U[0,1] (the online fine-tuner's protocol,
    darts_ft_model.py:221-240); BM3D's target is ops/denoise.dct_denoise.
    The targets run under no_grad on the device, so on the card the
    bilateral, median and fast-NLM targets launch the Hopper kernels;
  * demosaic proxies: SRCNN-demosaic imitators of bilinear / Malvar;
  * native CNN ops, trained on their task:
      demosaicnet  : clean mosaic -> clean BGR
      path_bayer   : noisy mosaic -> clean mosaic
      path_bgr     : noisy BGR    -> clean BGR

The plans, their order and every draw of the numpy generator are the JAX
package's, so an `ops` subset consumes the same samples.  Initial weights
come from a torch.Generator seeded with `seed` (the JAX package splits a
PRNG key), and Adam is torch.optim.Adam with the JAX package's betas
(0.9, 0.99) and eps 1e-8 (its utils/optim.adam_update has torch semantics).

CLI: python -m reconfigisp_tpu_torch.search.proxy_pretrain --steps 2000 \
        --out proxies.ckpt [--ops reinhard,median] [--device cpu]
The checkpoint (JAX layout) is read by run_training via
`path.pretrain_proxies`, in either package.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from reconfigisp_tpu_torch import convert
from reconfigisp_tpu_torch.data.datasets import SyntheticRawDataset
from reconfigisp_tpu_torch.pipeline import resolve_device
from reconfigisp_tpu_torch.registry import pool
from reconfigisp_tpu_torch.utils import checkpoint, losses


def _make_scene_sampler(batch: int, size: int, seed: int):
    scene = SyntheticRawDataset(n=1, size=size, noise_std=0.02, seed=seed)

    def sample(i: int) -> np.ndarray:
        imgs = [scene._scene(np.random.default_rng(seed * 7 + i * 131 + k),
                             size) for k in range(batch)]
        return np.stack(imgs)

    return sample


def _mosaic_batch(bgr: np.ndarray) -> np.ndarray:
    return np.stack([SyntheticRawDataset.mosaic_rggb(im) for im in bgr])


@dataclasses.dataclass
class Plan:
    """One module's pretraining: `init` (torch.Generator -> module),
    `apply` (x, params, module) -> output, `target` (x, params) -> target
    computed on the device (None when `sample` gives it), and `sample`
    (step i -> (x, params or None, target or None), numpy)."""
    name: str
    init: Callable
    apply: Callable
    target: Optional[Callable]
    sample: Callable


def make_plans(batch: int, size: int, seed: int, noise_std: float,
               rng: np.random.Generator) -> list:
    """Every module's plan, in the JAX package's order; the samplers draw
    from `rng` when called."""
    sample_scene = _make_scene_sampler(batch, size, seed)
    plans = []

    # sRGB proxies: imitate the native algorithm on random params
    for spec in pool("srgb"):
        if spec.proxy_apply is None or spec.ft_target_fn() is None:
            continue

        def sample(i, _spec=spec):
            x = sample_scene(i)
            p = rng.random((1, _spec.n_params)).astype(np.float32)
            return x, np.repeat(p, batch, axis=0), None

        plans.append(Plan(spec.name, spec.proxy_init, spec.proxy_apply,
                          lambda x, p, _tf=spec.ft_target_fn(): _tf(x, p, None),
                          sample))

    # demosaic proxies: imitate the native demosaic on mosaics
    for spec in pool("demosaic"):
        if spec.proxy_apply is None or spec.apply is None:
            continue

        def sample(i):
            return _mosaic_batch(sample_scene(i)), None, None

        plans.append(Plan(spec.name, spec.proxy_init, spec.proxy_apply,
                          lambda x, p, _s=spec: _s.apply(x, None, None),
                          sample))

    # native CNN ops: train on their real task
    by_name = {s.name: s for dom in ("bayer", "demosaic", "srgb")
               for s in pool(dom)}

    def add_native(name, sample_fn):
        spec = by_name[name]
        plans.append(Plan(name, spec.init_weights,
                          lambda x, p, w, _s=spec: _s.apply(x, p, w),
                          None, sample_fn))

    def dem_sample(i):
        bgr = sample_scene(i)
        return _mosaic_batch(bgr), None, bgr

    def bayer_sample(i):
        bgr = sample_scene(i)
        clean = _mosaic_batch(bgr)
        noisy = np.clip(clean + rng.normal(0, noise_std, clean.shape),
                        0, 1).astype(np.float32)
        return noisy, None, clean

    def bgr_sample(i):
        bgr = sample_scene(i)
        noisy = np.clip(bgr + rng.normal(0, noise_std, bgr.shape),
                        0, 1).astype(np.float32)
        return noisy, None, bgr

    add_native("demosaicnet", dem_sample)
    add_native("path_bayer", bayer_sample)
    add_native("path_bgr", bgr_sample)
    return plans


def train_plan(plan: Plan, module: torch.nn.Module, steps: int, *,
               lr: float = 1e-3, log_every: int = 100,
               verbose: bool = True) -> tuple:
    """`steps` Adam steps of `module` (on its device) on the plan's l2 ->
    (module, the first and the last step's losses as floats, mean seconds
    per step after the first)."""
    dev = next(module.parameters()).device
    module.requires_grad_(True)
    optimizer = torch.optim.Adam(module.parameters(), lr=lr,
                                 betas=(0.9, 0.99), eps=1e-8)

    def tensor(a):
        return None if a is None else torch.from_numpy(
            np.asarray(a, np.float32)).to(dev)

    first = t1 = None
    for i in range(steps):
        if i == 1:
            first = float(first)   # waits for step 1, before the clock
            t1 = time.perf_counter()
        x, params, target = plan.sample(i)
        x, params, target = tensor(x), tensor(params), tensor(target)
        if plan.target is not None:
            with torch.no_grad():
                target = plan.target(x, params)
        loss = losses.l2(plan.apply(x, params, module), target)
        if i == 0:
            first = loss.detach()
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        if verbose and (i + 1) % log_every == 0:
            print(f"[{plan.name}] step {i + 1}/{steps} "
                  f"l2 {float(loss.detach()):.3e}", flush=True)
    final = float(loss.detach())
    s_per_step = (time.perf_counter() - t1) / (steps - 1) if t1 else None
    module.requires_grad_(False)
    return module, float(first), final, s_per_step


# Failures a long pretraining run should survive (device out of memory, file
# system errors); programming errors propagate.
def _transient_errors() -> tuple:
    return (torch.cuda.OutOfMemoryError, OSError)


def pretrain_modules(steps: int = 1000, *, batch: int = 8, size: int = 48,
                     lr: float = 1e-3, seed: int = 0,
                     ops: Optional[set] = None, noise_std: float = 0.06,
                     log_every: int = 100, verbose: bool = True,
                     strict: bool = False, device=None,
                     report: Optional[dict] = None) -> dict:
    """-> {op_name: weights pytree (JAX layout, numpy)} for every learned
    module, or the `ops` subset, trained on `device` (cuda unless "cpu" is
    named).  `report`, when given, receives {op_name: {"first_loss",
    "loss": the first and the last step's l2, "s_per_step": mean seconds
    per step after the first}}."""
    dev = resolve_device(device)
    generator = torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(seed)
    trained = {}
    for plan in make_plans(batch, size, seed, noise_std, rng):
        if ops is not None and plan.name not in ops:
            continue
        module = plan.init(generator).to(dev)
        try:
            module, first, loss, s_per_step = train_plan(
                plan, module, steps, lr=lr, log_every=log_every,
                verbose=verbose)
        except _transient_errors() as e:
            # one op failing on a transient error must not lose the rest of
            # a long run; strict re-raises instead
            if strict:
                raise
            print(f"[{plan.name}] FAILED: {e}", flush=True)
            continue
        trained[plan.name] = convert.weights_to_jax(
            dict(module.named_parameters()))
        if report is not None:
            report[plan.name] = {"first_loss": first, "loss": loss,
                                 "s_per_step": s_per_step}
        if verbose:
            print(f"[{plan.name}] done, final l2 {loss:.3e}", flush=True)
    return trained


def pretrain_proxies(steps: int = 1000, *, ops: Optional[set] = None,
                     **kw) -> dict:
    """pretrain_modules restricted to the sRGB proxies when ops is None."""
    if ops is None:
        ops = {s.name for s in pool("srgb")
               if s.proxy_apply is not None and s.ft_target_fn() is not None}
    return pretrain_modules(steps, ops=ops, **kw)


def main():
    ap = argparse.ArgumentParser(
        description="Pretrain the search space's learned modules.")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=48)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--out", default="proxies.ckpt")
    ap.add_argument("--ops", default=None,
                    help="comma-separated subset of op names")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()
    ops = set(args.ops.split(",")) if args.ops else None
    trained = pretrain_modules(steps=args.steps, batch=args.batch,
                               size=args.size, lr=args.lr, ops=ops,
                               device=args.device)
    # the checkpoint at --out itself (the JAX CLI's save_network call names
    # it <stem>_proxies.ckpt beside it)
    d, f = os.path.split(args.out)
    path = checkpoint.save_network(d or ".", "proxies",
                                   f.replace(".ckpt", ""), trained)
    os.replace(path, args.out)
    print(f"saved {len(trained)} module weight sets to {args.out}")


if __name__ == "__main__":
    main()

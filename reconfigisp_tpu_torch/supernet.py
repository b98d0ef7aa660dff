"""Differentiable supernet: per-slot mixed ops with online path pruning.

Counterpart of reconfigisp_tpu/supernet.py (reference
super_prune_fifteen_demos_four_bayer_two.py:13-230).  The slots are
[bayer (2 ops), demosaic (4 ops), step1..stepN (the first `srgb_count` sRGB
ops)].  Each slot's output is the sum of every candidate's output weighted
by its post-pruning probability: softmax(alpha), then paths under
threshold x max set to 0 and the rest renormalised by a sum that carries no
gradient.  A pruned candidate is still computed and multiplied by an exact 0,
as in the JAX package.

Variables are plain dicts, as the JAX pytree:
  {"alphas": {slot: (K,) tensor},
   "theta":  {slot: {op_name: (P,) logits}},
   "omega":  {op_name: nn.Module}}   # learned weights, shared by the slots,
                                     # frozen in the search (requires_grad off)
The DARTS step (search/darts.py) differentiates the alphas and theta it
passes in; omega is tuned only by DartsFtTrainer.finetune_proxies.

The forward also gives the expected latency (the sum over slots of post-prune
probability times registry.LATENCY_MS_PER_MP; None while any op of the slots
has no entry) and the pruned paths per slot.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from reconfigisp_tpu_torch.ops import cnn
from reconfigisp_tpu_torch.pipeline import resolve_device
from reconfigisp_tpu_torch.registry import SUPERNET_SRGB_COUNT, pool

_DOMAIN_TOKENS = {"bayer": "Bayer", "demosaic": "Demosaic", "srgb": "sRGB"}


def _run(fn, remat: bool, *args):
    """fn(*args), recomputed in the backward instead of stored under
    `remat` (jax.checkpoint's counterpart) where a graph is recorded."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


class SuperNet:
    """SuperNet(n_step, threshold, use_proxies=False, srgb_count=15,
    remat=True, device=None).

    n_step sRGB slots; `threshold` the pruning ratio (reference
    prune_threshold); `use_proxies` searches through the CNN proxies where
    they exist (bm3d is a proxy either way); `remat` recomputes each
    candidate in the backward (torch.utils.checkpoint) instead of keeping its
    activations.  Runs on `device`: cuda unless "cpu" is asked for; raises
    without CUDA."""

    def __init__(self, n_step: int, threshold: float,
                 use_proxies: bool = False,
                 srgb_count: int = SUPERNET_SRGB_COUNT,
                 remat: bool = True, device=None):
        self.n_step = n_step
        self.threshold = threshold
        self.use_proxies = use_proxies
        self.remat = remat
        self.device = resolve_device(device)
        srgb_ops = pool("srgb")[:srgb_count]
        self.slots = [("bayer", pool("bayer")), ("demosaic", pool("demosaic"))]
        self.slots += [(f"step{k + 1}", srgb_ops) for k in range(n_step)]

    # ------------------------------------------------------------------ state

    def init(self, generator: Optional[torch.Generator] = None) -> dict:
        """Zero alphas, each op's init logits, and omega drawn from
        `generator` (a CPU torch.Generator, seeded 0 when not given)."""
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        alphas, theta, omega = {}, {}, {}
        for slot_name, ops in self.slots:
            alphas[slot_name] = torch.zeros(len(ops), device=self.device)
            slot_theta = {}
            for spec in ops:
                if spec.conditional:
                    continue  # conditional ops serve fixed pipelines only
                if spec.n_params:
                    slot_theta[spec.name] = torch.tensor(
                        spec.init_logits, dtype=torch.float32,
                        device=self.device)
                init = spec.get_init(self.use_proxies)
                if init is not None and spec.name not in omega:
                    omega[spec.name] = init(gen).to(self.device).requires_grad_(False)
            theta[slot_name] = slot_theta
        return {"alphas": alphas, "theta": theta, "omega": omega}

    # ---------------------------------------------------------------- forward

    def _bankable(self, spec) -> bool:
        """The sRGB SRCNN-Res proxies share one architecture, so a slot's
        run as one grouped conv stack (ops/cnn.apply_srcnn_res_bank)."""
        if spec.domain != "srgb":
            return False
        if spec.proxy_only:
            return True
        return (self.use_proxies and spec.proxy_apply is not None
                and spec.ft_target)

    def __call__(self, variables: dict, x: torch.Tensor, *,
                 return_aux: bool = False, fuse_banks: bool = True):
        """x (N,H,W,1) Bayer -> (N,H,W,3) BGR.  With return_aux:
        (y, {"intermediates": [slot outputs], "latency": scalar tensor or
        None, "pruned": (n_slots,) int64})."""
        n = x.shape[0]
        mids, pruned = [], []
        latency = x.new_zeros(())
        has_latency = True
        for slot_name, ops in self.slots:
            probs = torch.softmax(variables["alphas"][slot_name], dim=0)
            detached = probs.detach()
            keep = detached >= self.threshold * detached.max()
            post = torch.where(keep, probs, torch.zeros_like(probs))
            post = post / post.sum().detach()

            bank = [i for i, s in enumerate(ops)
                    if fuse_banks and self._bankable(s)]
            if len(bank) < 2:
                bank = []
            c = 1 if ops[0].domain == "bayer" else 3
            y = x.new_zeros((n, x.shape[1], x.shape[2], c))
            for i, spec in enumerate(ops):
                if spec.latency is None:
                    has_latency = False
                else:
                    latency = latency + post[i] * spec.latency
                if i in bank:
                    continue
                params = self._params_for(variables, slot_name, spec, n,
                                          x.dtype)
                weights = variables["omega"].get(spec.name)
                out = _run(spec.get_apply(self.use_proxies), self.remat, x,
                           params, weights)
                y = y + post[i] * out
            if bank:
                nets = [variables["omega"][ops[i].name] for i in bank]
                pstack = torch.stack([F.pad(
                    self._params_for(variables, slot_name, ops[i], n,
                                     x.dtype),
                    (0, cnn.MAX_PROXY_PARAMS - ops[i].n_params))
                    for i in bank])
                outs = _run(lambda x_, p_: cnn.apply_srcnn_res_bank(
                    nets, x_, p_), self.remat, x, pstack)
                y = y + torch.einsum("k,knhwc->nhwc", post[bank], outs)
            pruned.append((~keep).sum())
            mids.append(y)
            x = y
        if not return_aux:
            return x
        return x, {"intermediates": mids,
                   "latency": latency if has_latency else None,
                   "pruned": torch.stack(pruned)}

    @staticmethod
    def _params_for(variables, slot_name, spec, n, dtype):
        if spec.n_params == 0:
            return None
        p01 = torch.sigmoid(variables["theta"][slot_name][spec.name]).to(dtype)
        return p01[None, :].expand(n, spec.n_params)

    # -------------------------------------------------------------- utilities

    def argmax_architecture(self, variables: dict) -> str:
        """The alphas' argmax per slot as an architecture string that
        Pipeline takes (the reference's step-2 handoff)."""
        parts, last_domain = [], None
        for slot_name, ops in self.slots:
            idx = int(torch.argmax(variables["alphas"][slot_name]))
            domain = ops[0].domain
            if domain != last_domain:
                parts.append(_DOMAIN_TOKENS[domain])
                last_domain = domain
            parts.append(f"{idx + 1:02d}")
        return "_".join(parts)

    @property
    def slot_names(self):
        return [s for s, _ in self.slots]

"""Learning-rate schedules as pure functions step -> lr scale.

A copy of reconfigisp_tpu/utils/schedule.py, which is plain Python (the port
imports nothing of the JAX package): MultiStepLR with restarts, cosine
annealing with restarts, and linear warm-up (reference
codes/models/lr_scheduler.py:8-62, base_model.py:51-63).  The trainer sets
each parameter group's lr to lr_G times the scale of its step.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence


def multistep_restart(step: int, milestones: Sequence[int],
                      gamma: float = 0.5,
                      restarts: Optional[Sequence[int]] = None,
                      restart_weights: Optional[Sequence[float]] = None) -> float:
    """gamma**(#milestones passed), with optional restarts that reset the
    decay and apply a weight (reference lr_scheduler.py:8-31)."""
    restarts = list(restarts or [])
    restart_weights = list(restart_weights or [])
    weight = 1.0
    last_restart = 0
    for r, w in zip(restarts, restart_weights):
        if step >= r:
            weight, last_restart = w, r
    n_decays = sum(1 for m in milestones if last_restart < m <= step)
    return weight * (gamma ** n_decays)


def cosine_restart(step: int, t_period: Sequence[int],
                   eta_min_ratio: float = 0.0,
                   restarts: Optional[Sequence[int]] = None,
                   restart_weights: Optional[Sequence[float]] = None) -> float:
    """Cosine annealing over successive periods with restart weights
    (reference lr_scheduler.py:34-62).  eta_min_ratio = eta_min / lr_init."""
    restarts = list(restarts or [])
    restart_weights = list(restart_weights or [])
    weight = 1.0
    last_restart = 0
    period_idx = 0
    for i, r in enumerate(restarts):
        if step >= r:
            weight = restart_weights[i]
            last_restart = r
            period_idx = i + 1
    t = t_period[min(period_idx, len(t_period) - 1)]
    frac = (step - last_restart) / max(t, 1)
    frac = min(frac, 1.0)
    return eta_min_ratio + (weight - eta_min_ratio) * 0.5 * (
        1 + math.cos(math.pi * frac))


def with_warmup(scale: float, step: int, warmup_iter: int) -> float:
    """Linear warm-up from 0 over warmup_iter steps (reference
    base_model.py:51-63; warmup_iter=-1 disables)."""
    if warmup_iter is None or warmup_iter <= 0 or step >= warmup_iter:
        return scale
    return scale * step / warmup_iter


def make_schedule(train_opt: dict):
    """step -> lr_scale from a reference-style train options dict
    (lr_scheme MultiStepLR / CosineAnnealingLR_Restart,
    reference darts_model.py:94-110)."""
    scheme = train_opt.get("lr_scheme", "MultiStepLR")
    warmup = train_opt.get("warmup_iter", -1) or -1

    if scheme == "MultiStepLR":
        def sched(step):
            s = multistep_restart(
                step, train_opt.get("lr_steps") or [],
                train_opt.get("lr_gamma", 0.5),
                train_opt.get("restarts"), train_opt.get("restart_weights"))
            return with_warmup(s, step, warmup)
    elif scheme == "CosineAnnealingLR_Restart":
        def sched(step):
            lr0 = train_opt.get("lr_G", 1e-4)
            eta_ratio = (train_opt.get("eta_min", 0.0) or 0.0) / lr0
            s = cosine_restart(
                step, train_opt.get("T_period") or [train_opt.get("niter", 1)],
                eta_ratio, train_opt.get("restarts"),
                train_opt.get("restart_weights"))
            return with_warmup(s, step, warmup)
    else:
        raise NotImplementedError(f"lr_scheme {scheme!r}")
    return sched

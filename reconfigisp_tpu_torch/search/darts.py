"""DARTS bilevel search step, first and second order.

Counterpart of reconfigisp_tpu/search/darts.py (reference
codes/models/darts_model.py:19-330).  The step is a function of the
variables and the optimiser state, as in the JAX package: each pass takes
fresh leaf copies of the tensors it differentiates (torch.autograd.grad, no
.grad fields, nothing the state holds is changed in place), and the step
returns new dicts.  The second-order step runs five forward and backward
passes:
  1. the weights' gradient on the training batch, and the virtual step
     theta_v = theta - lr_meta (mu buf + g);
  2. the validation loss's gradients with respect to (alphas, theta_v);
  3. and 4. the alphas' gradient on the training batch at
     theta +- eps dtheta_v, eps = 0.01 / |dtheta_v| (0 below 1e-6), for the
     finite-difference Hessian term (pos - neg) / (2 eps), the corrected
     quotient (the reference multiplies by eps, darts_model.py:323);
  5. after Adam on the alphas, the weights' gradient at the new alphas on
     the training batch, for SGD with momentum on theta.
The first-order step takes the validation gradient of the alphas at the
current weights in place of 1-4.  A gradient that does not reach a tensor
(the median's logit, a path multiplied by an exact 0) is zeros, as JAX
gives, not None: every tensor's optimiser state moves every step.  The
optimisers follow torch's semantics, as the JAX package's do: SGD
buf = mu buf + g, p -= lr buf; Adam with bias correction and eps after the
square root.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class DartsConfig:
    lr_theta: float = 1e-4        # lr_G (reference yml train.lr_G)
    momentum: float = 0.9         # momentum_G
    lr_meta: float = 1e-4         # virtual-step lr
    lr_alpha: float = 1e-4        # Adam lr for alphas (= lr_G in reference)
    beta1: float = 0.9
    beta2: float = 0.99
    adam_eps: float = 1e-8
    # 2 = the reference's unrolled bilevel step (5 passes); 1 = first-order
    # DARTS (2 passes), the JAX package's extension
    order: int = 2


def _map(fn, *trees):
    """fn over the leaves of nested dicts of the same structure."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]


def _unflatten(tree, flat):
    it = iter(flat)
    return _map(lambda _: next(it), tree)


def _leaf_copies(tree, requires_grad: bool):
    return _map(lambda t: t.detach().requires_grad_(requires_grad), tree)


def _grad(loss: torch.Tensor, tree) -> dict:
    """d loss / d tree, zeros where the loss does not reach a leaf."""
    leaves = _leaves(tree)
    if not loss.requires_grad:
        return _map(torch.zeros_like, tree)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return _unflatten(tree, [g.detach() for g in grads])


def _global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in _leaves(tree)))


def init_darts_opt_state(variables: dict) -> dict:
    """Momentum buffer for theta; Adam moments for the alphas."""
    return {"momentum": _map(torch.zeros_like, variables["theta"]),
            "adam_m": _map(torch.zeros_like, variables["alphas"]),
            "adam_v": _map(torch.zeros_like, variables["alphas"]),
            "adam_t": torch.zeros((), dtype=torch.int32,
                                  device=_leaves(variables["alphas"])[0].device)}


def make_darts_step(forward: Callable, criterion: Callable,
                    cfg: DartsConfig) -> Callable:
    """step(variables, opt_state, batch, lr_scale) -> (variables, opt_state,
    logs).

    forward(theta, alphas, omega, img) -> (pred, latency) or (pred, latency,
    mids); mids (e.g. the supernet's 3-channel intermediates) of the final
    training pass come back detached in logs["_mids"].  criterion(pred,
    target, latency=..., [glb_flag=...]) -> scalar.  The batch holds "img",
    "gt", "val_img", "val_gt" and optionally "glb_flag", "val_glb_flag".
    lr_scale multiplies both learning rates (the schedule).  The logs
    "loss", "val_loss", "eps" and "dtheta_norm" are 0-d tensors."""

    def loss_on(theta, alphas, omega, img, gt, flag=None):
        out = forward(theta, alphas, omega, img)
        pred, latency = out[0], out[1]
        mids = out[2] if len(out) > 2 else None
        kw = {} if flag is None else {"glb_flag": flag}
        return criterion(pred, gt, latency=latency, **kw), mids

    def step(variables, opt_state, batch, lr_scale):
        theta, alphas, omega = (variables["theta"], variables["alphas"],
                                variables["omega"])
        img, gt = batch["img"], batch["gt"]
        val_img, val_gt = batch["val_img"], batch["val_gt"]
        flag, val_flag = batch.get("glb_flag"), batch.get("val_glb_flag")
        lr_theta = cfg.lr_theta * lr_scale
        lr_alpha = cfg.lr_alpha * lr_scale
        alphas = _map(torch.detach, alphas)
        theta = _map(torch.detach, theta)

        if cfg.order == 1:
            a = _leaf_copies(alphas, True)
            val_loss, _ = loss_on(theta, a, omega, val_img, val_gt, val_flag)
            dalpha = _grad(val_loss, a)
            g_alpha = _map(lambda d: torch.where(
                torch.isnan(d).any(), torch.zeros_like(d), d), dalpha)
            eps = norm = torch.zeros((), device=val_loss.device)
        else:
            # 1) virtual step: theta_v = theta - lr_meta (mu buf + g)
            t = _leaf_copies(theta, True)
            g_w = _grad(loss_on(t, alphas, omega, img, gt, flag)[0], t)
            theta_v = _map(lambda p, buf, g: p - cfg.lr_meta * (
                cfg.momentum * buf + g), theta, opt_state["momentum"], g_w)

            # 2) the unrolled validation loss's gradients
            a = _leaf_copies(alphas, True)
            tv = _leaf_copies(theta_v, True)
            val_loss, _ = loss_on(tv, a, omega, val_img, val_gt, val_flag)
            grads = _grad(val_loss, {"a": a, "tv": tv})
            dalpha, dtheta_v = grads["a"], grads["tv"]

            # 3), 4) the finite-difference Hessian-vector term
            norm = _global_norm(dtheta_v)
            eps = torch.where(norm < 1e-6, torch.zeros_like(norm),
                              0.01 / torch.clamp(norm, min=1e-6))

            def dalpha_at(sign):
                t_ = _map(lambda p, d: p + sign * eps * d, theta, dtheta_v)
                a_ = _leaf_copies(alphas, True)
                return _grad(loss_on(t_, a_, omega, img, gt, flag)[0], a_)

            pos, neg = dalpha_at(1.0), dalpha_at(-1.0)
            denom = torch.where(eps > 0, 2.0 * eps, torch.ones_like(eps))
            hessian = _map(lambda p_, n_: torch.where(
                eps > 0, (p_ - n_) / denom, torch.zeros_like(p_)), pos, neg)

            # the reference's NaN guard (darts_model.py:260-263): a NaN
            # zeroes that slot's gradient
            def alpha_grad(da, h):
                g = da - cfg.lr_meta * h
                bad = torch.isnan(h).any() | torch.isnan(da).any()
                return torch.where(bad, torch.zeros_like(g), g)

            g_alpha = _map(alpha_grad, dalpha, hessian)

        # Adam on the alphas
        t_adam = opt_state["adam_t"] + 1
        tf = t_adam.float()
        bc1 = 1 - cfg.beta1 ** tf
        bc2 = 1 - cfg.beta2 ** tf
        m = _map(lambda m_, g: cfg.beta1 * m_ + (1 - cfg.beta1) * g,
                 opt_state["adam_m"], g_alpha)
        v = _map(lambda v_, g: cfg.beta2 * v_ + (1 - cfg.beta2) * g * g,
                 opt_state["adam_v"], g_alpha)
        new_alphas = _map(lambda p, m_, v_: p - lr_alpha * (m_ / bc1) / (
            torch.sqrt(v_ / bc2) + cfg.adam_eps), alphas, m, v)

        # 5) SGD with momentum on theta at the new alphas (the reference
        # steps the alphas before the weights, train.py:207-209)
        t = _leaf_copies(theta, True)
        train_loss, mids = loss_on(t, new_alphas, omega, img, gt, flag)
        g_theta = _grad(train_loss, t)
        new_buf = _map(lambda buf, g: cfg.momentum * buf + g,
                       opt_state["momentum"], g_theta)
        new_theta = _map(lambda p, b: p - lr_theta * b, theta, new_buf)

        new_vars = {"theta": new_theta, "alphas": new_alphas, "omega": omega}
        new_opt = {"momentum": new_buf, "adam_m": m, "adam_v": v,
                   "adam_t": t_adam}
        logs = {"loss": train_loss.detach(), "val_loss": val_loss.detach(),
                "eps": eps, "dtheta_norm": norm}
        if mids is not None:
            logs["_mids"] = mids.detach()
        return new_vars, new_opt, logs

    return step

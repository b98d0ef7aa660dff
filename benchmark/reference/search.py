"""Plain reference of the SID DARTS search step (second order).

The supernet: each slot's output is the sum of its candidates' outputs
weighted by softmax(alpha) after pruning (paths under threshold x the
largest probability set to 0, the rest divided by their sum, which carries
no gradient).  The step (DARTS, Liu et al. 2019, as ReconfigISP's
darts_model.py runs it, with the finite-difference term divided by 2 eps):

  1. g_w = d L_train / d theta;  theta_v = theta - lr_meta (mu buf + g_w)
  2. d L_val(alpha, theta_v) / d alpha and / d theta_v
  3-4. h = (d L_train(theta + e v) - d L_train(theta - e v)) / (2 e) by alpha,
     v = d L_val / d theta_v, e = 0.01 / |v| (0 when |v| < 1e-6)
  g_alpha = dL_val/d alpha - lr_meta h (zero for a slot with a NaN);
  Adam on the alphas (bias-corrected, eps after the square root);
  5. SGD with momentum on theta from d L_train / d theta at the new alphas.

The learned modules (omega) are frozen.  The losses are means of squared
errors.
"""

from __future__ import annotations

import torch

from benchmark.reference import ops, zoo

NATIVE = {
    "gamma": ops.gamma, "reinhard": ops.tone_reinhard,
    "crysisengine": ops.tone_crysis, "filmic": ops.tone_filmic,
    "grayworld": ops.grayworld, "whiteworld": ops.wb_whiteworld,
    "bilateral": ops.bilateral, "median": ops.median,
    "fastnlm": ops.fastnlm, "skip": ops.skip, "wbmanual": ops.wb_manual,
    "wbquadratic": ops.wb_quadratic, "gtmmanual": ops.gtm_manual,
}
DEMOSAIC_METHOD = {"nearest": "nearest", "bilinear": "bilinear",
                   "laplacian": "malvar"}


def apply_op(op: str, x, params, omega, use_proxies: bool,
             storage: str = "f32"):
    """One candidate on x; `storage` is the CNNs' (reference/ops.conv)."""
    kind = zoo.module_kind(op, use_proxies)
    if kind == "path_bayer":
        return ops.path_bayer(x, omega[op], storage)
    if kind == "path_bgr":
        return ops.path_bgr(x, omega[op], storage)
    if kind == "srcnn_demosaic":
        return ops.srcnn_demosaic(x, omega[op], storage)
    if kind == "srcnn_res":
        return ops.srcnn_res(x, params, omega[op], storage)
    if op in DEMOSAIC_METHOD:
        return ops.demosaic(x, DEMOSAIC_METHOD[op])
    return NATIVE[op](x, params)


def supernet(alphas, theta, omega, x, *, n_step: int, threshold: float,
             use_proxies: bool):
    """(N, H, W, 1) mosaics -> (N, H, W, 3) BGR."""
    n = x.shape[0]
    for slot, candidates in zoo.slots(n_step):
        probs = torch.softmax(alphas[slot], dim=0)
        held = probs.detach()
        keep = held >= threshold * held.max()
        post = torch.where(keep, probs, torch.zeros_like(probs))
        post = post / post.sum().detach()
        y = 0.0
        for i, op in enumerate(candidates):
            logits = theta[slot].get(op)
            params = None if logits is None else ops.sigmoid_params(logits, n)
            y = y + post[i] * apply_op(op, x, params, omega, use_proxies)
        x = y
    return x


def _tmap(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tmap(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _flat(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _flat(v)]
    return [tree]


def _grad(loss, tree):
    leaves = _flat(tree)
    got = iter(torch.autograd.grad(loss, leaves, allow_unused=True,
                                   materialize_grads=True))
    return _tmap(lambda _: next(got).detach(), tree)


def _leaf(tree):
    return _tmap(lambda t: t.detach().clone().requires_grad_(True), tree)


def darts_step(state: dict, batch: dict, cfg: dict):
    """One second-order step.  state: {"alphas", "theta", "omega", "buf",
    "m", "v", "t"}; batch: {"img", "gt", "val_img", "val_gt"}; cfg: n_step,
    threshold, use_proxies, lr, momentum, lr_meta, beta1, beta2, and
    `batch_rows` (None, or the rows of each batch the step keeps, for the
    fault that leaves half of the batch out).  -> (new state, {"loss",
    "val_loss"}), the training loss at the new alphas and the validation
    loss of pass 2."""
    lr, mu, lr_meta = cfg["lr"], cfg["momentum"], cfg["lr_meta"]
    b1, b2 = cfg["beta1"], cfg["beta2"]
    rows = cfg.get("batch_rows")
    batch = {k: v if rows is None else v[:rows] for k, v in batch.items()}
    omega = state["omega"]
    alphas = _tmap(torch.detach, state["alphas"])
    theta = _tmap(torch.detach, state["theta"])

    def loss(th, al, img, gt):
        pred = supernet(al, th, omega, img, n_step=cfg["n_step"],
                        threshold=cfg["threshold"],
                        use_proxies=cfg["use_proxies"])
        return torch.mean((pred - gt) ** 2)

    t = _leaf(theta)
    g_w = _grad(loss(t, alphas, batch["img"], batch["gt"]), t)
    theta_v = _tmap(lambda p, b, g: p - lr_meta * (mu * b + g),
                    theta, state["buf"], g_w)

    a, tv = _leaf(alphas), _leaf(theta_v)
    val_loss = loss(tv, a, batch["val_img"], batch["val_gt"])
    grads = _grad(val_loss, {"a": a, "tv": tv})
    dalpha, v = grads["a"], grads["tv"]

    norm = torch.sqrt(sum(torch.sum(g ** 2) for g in _flat(v)))
    eps = 0.0 if float(norm) < 1e-6 else 0.01 / float(norm)

    def alpha_grad_at(sign):
        th = _tmap(lambda p, d: p + sign * eps * d, theta, v)
        al = _leaf(alphas)
        return _grad(loss(th, al, batch["img"], batch["gt"]), al)

    if eps > 0:
        pos, neg = alpha_grad_at(1.0), alpha_grad_at(-1.0)
        hess = _tmap(lambda p, q: (p - q) / (2.0 * eps), pos, neg)
    else:
        hess = _tmap(torch.zeros_like, dalpha)

    def guarded(d, h):
        g = d - lr_meta * h
        bad = bool(torch.isnan(d).any() or torch.isnan(h).any())
        return torch.zeros_like(g) if bad else g

    g_alpha = _tmap(guarded, dalpha, hess)
    step = state["t"] + 1
    m = _tmap(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], g_alpha)
    vv = _tmap(lambda v_, g: b2 * v_ + (1 - b2) * g * g, state["v"], g_alpha)
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
    new_alphas = _tmap(lambda p, m_, v_: p - lr * (m_ / bc1) / (
        torch.sqrt(v_ / bc2) + 1e-8), alphas, m, vv)

    t = _leaf(theta)
    train_loss = loss(t, new_alphas, batch["img"], batch["gt"])
    g_theta = _grad(train_loss, t)
    buf = _tmap(lambda b, g: mu * b + g, state["buf"], g_theta)
    new_theta = _tmap(lambda p, b: p - lr * b, theta, buf)
    new_state = {"alphas": new_alphas, "theta": new_theta, "omega": omega,
                 "buf": buf, "m": m, "v": vv, "t": step}
    return new_state, {"loss": float(train_loss.detach()),
                       "val_loss": float(val_loss.detach())}


def initial_state(alphas, theta, omega) -> dict:
    zeros = lambda tree: _tmap(torch.zeros_like, tree)  # noqa: E731
    return {"alphas": alphas, "theta": theta, "omega": omega,
            "buf": zeros(theta), "m": zeros(alphas), "v": zeros(alphas),
            "t": 0}


def run(state: dict, batches: list, cfg: dict) -> dict:
    """The steps over `batches` from `state` -> {"losses": [(loss,
    val_loss)], "grad": the first step's gradient as the optimisers take it
    ({"alphas", "theta"}), "after": the alphas and theta after the last
    step}."""
    losses, grad = [], None
    for batch in batches:
        state, logs = darts_step(state, batch, cfg)
        losses.append((logs["loss"], logs["val_loss"]))
        if grad is None:
            grad = {"alphas": _tmap(lambda m: m / (1 - cfg["beta1"]),
                                    state["m"]),
                    "theta": state["buf"]}
    return {"losses": losses, "grad": grad,
            "after": {"alphas": state["alphas"], "theta": state["theta"]}}

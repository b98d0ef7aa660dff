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
current weights in place of 1-4.

The step is the root span `darts.step` and its passes the spans
`darts.virtual`, `darts.unrolled`, `darts.hessian_pos`, `darts.hessian_neg`
and `darts.update` (1-5; a first-order step's are `darts.alpha` and
`darts.update`), each timed on the device for CUDA tensors
(utils/tracing.py); in a captured step they time every replay.

With a data group (`group=`, the mesh's data axis: the counterpart of the
JAX step's `axis_name`) the batch is this rank's shard and the criterion
returns its share of the global loss (utils/losses.py), so summing the
shares' gradients over the group (parallel/dp.reduce_grads) gives the
global batch's gradient, as the JAX trainers' sharded jit computes it.
With a space axis as well (`space=`, a parallel/space.SpaceAxis of the
mesh) the images are whole frames: each pass runs the network on this
rank's window under the space context, and the criterion sees the
prediction's owned rows gathered over the space group, the whole frame
(parallel/dp.py), and the gradients are summed over the whole mesh, the
data group and then the space group.  The step reduces where the JAX step
calls maybe_pmean: the weights' gradient of pass 1, the alphas' and
theta_v's of pass 2 (so eps comes from the global |dtheta_v|), the Hessian
term, the alphas' gradient of the first-order step and the weights' of
pass 5; and it sums the logged losses over the data group.  It sums, where
JAX's axis_name path takes a mean of per-shard gradients, which differs
from the sharded jit for a count-normalised loss.  A gradient that does not reach a tensor
(the median's logit, a path multiplied by an exact 0) is zeros, as JAX
gives, not None: every tensor's optimiser state moves every step.  The
optimisers follow torch's semantics, as the JAX package's do: SGD
buf = mu buf + g, p -= lr buf; Adam with bias correction and eps after the
square root.
"""

from __future__ import annotations

import dataclasses
import gc
import logging
import time
from typing import Callable

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from reconfigisp_tpu_torch.ops.kernels import _vjp
from reconfigisp_tpu_torch.parallel import space as spacelib
from reconfigisp_tpu_torch.parallel.dp import reduce_grads
from reconfigisp_tpu_torch.utils import tracing

log = logging.getLogger(__name__)


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
                    cfg: DartsConfig, group=None, space=None) -> Callable:
    """step(variables, opt_state, batch, lr_scale) -> (variables, opt_state,
    logs).

    forward(theta, alphas, omega, img) -> (pred, latency) or (pred, latency,
    mids); mids (e.g. the supernet's 3-channel intermediates) of the final
    training pass come back detached in logs["_mids"].  criterion(pred,
    target, latency=..., [glb_flag=...]) -> scalar.  The batch holds "img",
    "gt", "val_img", "val_gt" and optionally "glb_flag", "val_glb_flag".
    lr_scale multiplies both learning rates (the schedule): a number, or a
    0-d tensor, which a captured step reads on the device; either way the
    rates are float32 products, as in the JAX step, whose jit takes the
    scale as a float32 array.  The logs "loss", "val_loss", "eps" and
    "dtheta_norm" are 0-d tensors.  With `group`, the criterion is called
    with group= and the step reduces over it (module docstring); the logs
    are the global batch's.  With `space` (a parallel/space.SpaceAxis) the
    images are whole frames and the forward runs on this rank's windows;
    mids come back trimmed to the owned rows."""

    def loss_on(theta, alphas, omega, img, gt, flag=None):
        if space is not None:
            img = space.take(img)
        out = forward(theta, alphas, omega, img)
        pred, latency = out[0], out[1]
        mids = out[2] if len(out) > 2 else None
        if space is not None:
            pred = spacelib.gather(pred)
        kw = {} if flag is None else {"glb_flag": flag}
        if group is not None:
            kw["group"] = group
        return criterion(pred, gt, latency=latency, **kw), mids

    def reduce(tree):
        reduce_grads(_leaves(tree), group,
                     None if space is None else space.group)
        return tree

    def step(variables, opt_state, batch, lr_scale):
        with tracing.span("darts.step", device=batch["img"].is_cuda):
            if space is None:
                return body(variables, opt_state, batch, lr_scale)
            height = batch["img"].shape[1]
            if batch["val_img"].shape[1] != height:
                raise ValueError("the space axis takes training and "
                                 "validation frames of one height")
            with space.frame(height):
                return body(variables, opt_state, batch, lr_scale)

    def body(variables, opt_state, batch, lr_scale):
        theta, alphas, omega = (variables["theta"], variables["alphas"],
                                variables["omega"])
        img, gt = batch["img"], batch["gt"]
        val_img, val_gt = batch["val_img"], batch["val_gt"]
        flag, val_flag = batch.get("glb_flag"), batch.get("val_glb_flag")
        lr_scale = torch.as_tensor(lr_scale, dtype=torch.float32,
                                   device=img.device)
        lr_theta = cfg.lr_theta * lr_scale
        lr_alpha = cfg.lr_alpha * lr_scale
        alphas = _map(torch.detach, alphas)
        theta = _map(torch.detach, theta)
        on_device = img.is_cuda

        if cfg.order == 1:
            with tracing.span("darts.alpha", device=on_device):
                a = _leaf_copies(alphas, True)
                val_loss, _ = loss_on(theta, a, omega, val_img, val_gt,
                                      val_flag)
                dalpha = reduce(_grad(val_loss, a))
            g_alpha = _map(lambda d: torch.where(
                torch.isnan(d).any(), torch.zeros_like(d), d), dalpha)
            eps = norm = torch.zeros((), device=val_loss.device)
        else:
            # 1) virtual step: theta_v = theta - lr_meta (mu buf + g)
            with tracing.span("darts.virtual", device=on_device):
                t = _leaf_copies(theta, True)
                g_w = reduce(_grad(loss_on(t, alphas, omega, img, gt,
                                           flag)[0], t))
                theta_v = _map(lambda p, buf, g: p - cfg.lr_meta * (
                    cfg.momentum * buf + g), theta, opt_state["momentum"],
                    g_w)

            # 2) the unrolled validation loss's gradients
            with tracing.span("darts.unrolled", device=on_device):
                a = _leaf_copies(alphas, True)
                tv = _leaf_copies(theta_v, True)
                val_loss, _ = loss_on(tv, a, omega, val_img, val_gt,
                                      val_flag)
                grads = reduce(_grad(val_loss, {"a": a, "tv": tv}))
                dalpha, dtheta_v = grads["a"], grads["tv"]

            # 3), 4) the finite-difference Hessian-vector term
            norm = _global_norm(dtheta_v)
            eps = torch.where(norm < 1e-6, torch.zeros_like(norm),
                              0.01 / torch.clamp(norm, min=1e-6))

            def dalpha_at(sign, name):
                with tracing.span(name, device=on_device):
                    t_ = _map(lambda p, d: p + sign * eps * d, theta,
                              dtheta_v)
                    a_ = _leaf_copies(alphas, True)
                    return _grad(loss_on(t_, a_, omega, img, gt, flag)[0],
                                 a_)

            pos = dalpha_at(1.0, "darts.hessian_pos")
            neg = dalpha_at(-1.0, "darts.hessian_neg")
            denom = torch.where(eps > 0, 2.0 * eps, torch.ones_like(eps))
            hessian = reduce(_map(lambda p_, n_: torch.where(
                eps > 0, (p_ - n_) / denom, torch.zeros_like(p_)), pos, neg))

            # the reference's NaN guard (darts_model.py:260-263): a NaN
            # zeroes that slot's gradient
            def alpha_grad(da, h):
                g = da - cfg.lr_meta * h
                bad = torch.isnan(h).any() | torch.isnan(da).any()
                return torch.where(bad, torch.zeros_like(g), g)

            g_alpha = _map(alpha_grad, dalpha, hessian)

        with tracing.span("darts.update", device=on_device):
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

            # 5) SGD with momentum on theta at the new alphas (the
            # reference steps the alphas before the weights,
            # train.py:207-209)
            t = _leaf_copies(theta, True)
            train_loss, mids = loss_on(t, new_alphas, omega, img, gt, flag)
            g_theta = reduce(_grad(train_loss, t))
            new_buf = _map(lambda buf, g: cfg.momentum * buf + g,
                           opt_state["momentum"], g_theta)
            new_theta = _map(lambda p, b: p - lr_theta * b, theta, new_buf)

        new_vars = {"theta": new_theta, "alphas": new_alphas, "omega": omega}
        new_opt = {"momentum": new_buf, "adam_m": m, "adam_v": v,
                   "adam_t": t_adam}
        losses = {"loss": train_loss.detach(), "val_loss": val_loss.detach()}
        if group is not None:
            losses = _map(torch.clone, losses)
            reduce_grads(_leaves(losses), group)
        logs = {**losses, "eps": eps, "dtheta_norm": norm}
        if mids is not None:
            logs["_mids"] = mids.detach()
        return new_vars, new_opt, logs

    step.space = space
    return step


# ------------------------------------------------------------ K-step dispatch

def make_darts_multi_step(step: Callable, group=None) -> Callable:
    """K steps per dispatch: the counterpart of the JAX package's
    make_darts_multi_step (reconfigisp_tpu/search/darts.py:200-236), which
    scans them into one XLA program.

    multi(variables, opt_state, batches, lr_scales) -> (variables,
    opt_state, logs): the batch's tensors stacked on a leading (K,) axis,
    the lr scales a (K,) vector; the variables and optimiser state after K
    steps, the last step's scalar logs, and the `_mids` of every step
    flattened to (K n_mids, ...), so that the ft trainer's replay memory
    sees every step, as at one step a dispatch.  The results are those of
    K calls of `step` in order.

    On the CPU it calls `step` K times in order.  On CUDA the first call
    captures one step as a CUDA graph (_StepGraph) over static tensors,
    the state tensors it is given among them, and each call replays that
    graph K times: before each replay slot k of the batches and lr k are
    copied into the graph's inputs on the device, and the replay writes
    the new variables and state into the old ones.  So the state tensors
    are updated in place, and every call takes and returns the dicts of
    the first (other state is written into their tensors with copy_, as
    the trainers' resume does).  The graph holds one step,
    not K: a second-order step is some 10^5 kernel nodes or more, and a
    graph of K steps would take K times as long to capture and instantiate,
    and K times the memory, to save K - 1 launches of a graph.  `multi.graph`
    is the captured graph's runner, None before the first call on CUDA.

    `group` is the data group the step reduces over.  NCCL collectives are
    captured with the step; gloo's cannot be (they run on host copies), so
    under a gloo group the steps run eagerly on CUDA too, as on the CPU,
    and `multi.graph` stays None."""
    capture = group is None or dist.get_backend(group) == "nccl"

    def multi(variables, opt_state, batches, lr_scales):
        device = _leaves(variables["alphas"])[0].device
        if device.type == "cuda" and not capture and not multi.logged:
            multi.logged = True
            log.warning("search steps run eagerly on %s: the gloo group's "
                        "collectives cannot be captured in a CUDA graph",
                        device)
        if device.type == "cuda" and capture:
            if multi.graph is None:
                first = {k: v[0] for k, v in batches.items()}
                multi.graph = _StepGraph(step, variables, opt_state, first)
            return multi.graph(variables, opt_state, batches, lr_scales)
        mids = []
        for i in range(len(lr_scales)):
            variables, opt_state, logs = step(
                variables, opt_state, {k: v[i] for k, v in batches.items()},
                lr_scales[i])
            if "_mids" in logs:
                mids.append(logs.pop("_mids"))
        if mids:
            logs["_mids"] = torch.cat(mids)
        return variables, opt_state, logs

    multi.graph = None
    multi.logged = False
    multi.space = getattr(step, "space", None)
    return multi


class _LastOp(TorchDispatchMode):
    """Keeps the name of the last ATen op dispatched."""

    name = "no op"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.name = str(func)
        return func(*args, **(kwargs or {}))


def _failing_op(step, args) -> str:
    """The ATen op at which `step(*args)` raises with synchronising CUDA
    calls made errors, outside any capture: the op a capture of it cannot
    take."""
    mode = _LastOp()
    try:
        torch.cuda.set_sync_debug_mode("error")
        with mode, _vjp.static_bounds(), _vjp.tally_launches():
            step(*args)
    except Exception:  # noqa: BLE001 - any error names the op it came from
        return mode.name
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return ("no op of the step (each runs outside a capture; another "
            "thread's CUDA call may have ended it)")


class _StepGraph:
    """One DARTS step captured as a CUDA graph, and its replays.

    The graph's inputs are the state tensors it was built over (theta, the
    alphas, omega's modules and the optimiser state, which the step reads
    and, at the end of the captured region, overwrites with copy_), a
    buffer per batch tensor and the lr scale as a 0-d float32 tensor.
    Before the capture the step runs once on a side stream, as PyTorch's
    notes on CUDA graphs require: autograd's device thread, cuDNN's and
    cuBLAS's handles and workspaces and the kernels' first build and load
    then happen outside it.  The warm-up and the capture run the plain
    forms' capture-safe route (_vjp.static_bounds) and tally the kernels'
    launches apart (_vjp.tally_launches): the warm-up's in
    `warmup_launches`, as it is no step of the run; the capture's in
    `launches`, which each replay adds to the kernels' counts.  A capture
    that fails raises, naming the op; nothing falls back to eager steps.
    `warmup_s` is the warm-up's host time up to its synchronize,
    `capture_s` the capture's wall time, `record_s` the part of it that
    ran the step's Python (the rest instantiates the graph), and
    `pool_bytes` the device memory the capture allocated at its peak.
    `first_replay_s` is the first replay's host time inside
    `graph.replay()`, which uploads the graph to the device; `replays`
    counts the later replays made while no profiler records and
    `replay_host_s` sums their host time there.  Each replay is the span
    `search.replay`.  The step's device spans (utils/tracing.py) are
    captured as timing events in the graph, which every replay records
    anew: `device_spans()` reads them for the last replay that no profiler
    recorded (a profiled replay's, where none came before it), as a
    profiler's own stalls lengthen the replay it records."""

    def __init__(self, step, variables, opt_state, batch):
        self.step = step
        self.variables, self.opt_state = variables, opt_state
        self.device = _leaves(variables["alphas"])[0].device
        self.batch = {k: v.to(self.device).clone() for k, v in batch.items()}
        self.lr = torch.ones((), dtype=torch.float32, device=self.device)
        args = (variables, opt_state, self.batch, self.lr)
        self.first_replay_s = None
        self.replays, self.replay_host_s = 0, 0.0
        # whether the last replay was profiled (None before the first), and
        # the device spans of the unprofiled replay before a profiled one
        self._profiled, self._held = None, None

        t0 = time.perf_counter()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side), _vjp.static_bounds(), \
                _vjp.tally_launches() as warm:
            step(*args)
        torch.cuda.current_stream(self.device).wait_stream(side)
        self.warmup_launches = dict(warm)
        torch.cuda.synchronize(self.device)
        self.warmup_s = time.perf_counter() - t0

        before = torch.cuda.memory_allocated(self.device)
        torch.cuda.reset_peak_memory_stats(self.device)
        # A finalizer that frees another graph (cudaGraphExecDestroy) in the
        # middle of the capture would end it: collect first, and let no
        # collection run until the capture ends.
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        try:
            with _vjp.static_bounds(), _vjp.tally_launches() as tally, \
                    tracing.graph_spans() as spans:
                with torch.cuda.graph(self.graph):
                    new_vars, new_opt, logs = step(*args)
                    for key in ("theta", "alphas"):
                        _map(lambda s, t: s.copy_(t), variables[key],
                             new_vars[key])
                    _map(lambda s, t: s.copy_(t), opt_state, new_opt)
                    self.record_s = time.perf_counter() - t0
        except Exception as err:
            raise RuntimeError(
                "CUDA graph capture of the DARTS step failed at "
                f"{_failing_op(step, args)}: {err}") from err
        finally:
            if collecting:
                gc.enable()
        torch.cuda.synchronize(self.device)
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.max_memory_allocated(self.device) - before
        self.launches = dict(tally)
        self.spans = spans
        self.mids = logs.pop("_mids", None)
        self.logs = logs

    def __call__(self, variables, opt_state, batches, lr_scales):
        if variables is not self.variables or opt_state is not self.opt_state:
            raise ValueError("the step's graph runs over the state dicts it "
                             "was captured with: write new state into their "
                             "tensors (copy_)")
        staged = {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                  for k, v in batches.items()}
        for k, v in staged.items():
            if v.shape[1:] != self.batch[k].shape:
                raise ValueError(
                    f"the step's graph takes {k} of shape "
                    f"{tuple(self.batch[k].shape)}, got {tuple(v.shape[1:])}")
        lrs = torch.as_tensor(lr_scales, dtype=torch.float32).to(
            self.device, non_blocking=True)
        k_steps = lrs.shape[0]
        mids = (None if self.mids is None else self.mids.new_empty(
            (k_steps * self.mids.shape[0],) + self.mids.shape[1:]))
        for i in range(k_steps):
            for k, buf in self.batch.items():
                buf.copy_(staged[k][i])
            self.lr.copy_(lrs[i])
            profiled = tracing.profiling()
            if profiled and self._profiled is False:
                self._held = self._read()
            with tracing.span("search.replay"):
                t0 = time.perf_counter()
                self.graph.replay()
                dt = time.perf_counter() - t0
            if self.first_replay_s is None:
                self.first_replay_s = dt
            elif not profiled:
                self.replays += 1
                self.replay_host_s += dt
            if not profiled:
                self._held = None
            self._profiled = profiled
            _vjp.count_launches(self.launches)
            if mids is not None:
                n = self.mids.shape[0]
                mids[i * n:(i + 1) * n].copy_(self.mids)
        logs = {k: v.clone() for k, v in self.logs.items()}
        if mids is not None:
            logs["_mids"] = mids
        return self.variables, self.opt_state, logs

    def device_spans(self) -> list:
        """[(name, parent, ms)] of the step's captured spans in the last
        unprofiled replay (class docstring), the parent an index into the
        list; waits for the replay.  Empty before the first replay."""
        if self._profiled is None:
            return []
        return self._held if self._held is not None else self._read()

    def _read(self) -> list:
        out = []
        for name, parent, start, end in self.spans:
            end.synchronize()
            out.append((name, parent, start.elapsed_time(end)))
        return out

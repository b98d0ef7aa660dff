"""Search system: second-order DARTS steps of the port's DartsTrainer.

Set-up builds the configuration's SuperNet (config.supernet_kwargs) and one
DartsTrainer, writes the benchmark's initial state into it (omega drawn from
the seed on the device, theta at the ops' initial logits, zero alphas),
draws the traffic's pool of batch pairs, and runs the first three steps
through search_step, the window's own call: the first captures the step as
a CUDA graph (its time is `first_dispatch_s`).  The optimisers' state after
step 1 and the variables after step 3 are copied for the check.  The window
continues the same trainer, a step per pair of the pool in turn, each step
synchronised; one of its unprofiled steps, drawn from the seed (reservoir
sampling), is kept with the state just before it and just after it.  The
check runs the plain reference (reference/search.py) once the trainer is
freed: over the first three pairs from the same initial state, comparing
each step's losses, the first gradient as the optimisers took it and each
leaf's change over the three steps; and over the kept window step from the
program's state before it, comparing that step's losses, gradient and
change in the same way.
"""

from __future__ import annotations

import contextlib
import gc
import math
import random
import statistics
import sys
import time

import torch

from benchmark.lib import counts, weights
from benchmark.lib.device import tf32
from benchmark.lib import trace as tracelib
from benchmark.reference import ops as refops
from benchmark.reference import search as refsearch
from benchmark.reference import zoo

CHECKED_STEPS = 3
# the logit of a windowed op's window radius, and of fast NLM's block radius
RADIUS_PARAM = {"bilateral": 0, "median": 0, "fastnlm": 1}
BLOCK_PARAM = {"fastnlm": 0}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _tmap(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tmap(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _leaves(tree, prefix=""):
    """[(path, tensor)] of nested dicts."""
    if isinstance(tree, dict):
        return [leaf for k, v in tree.items()
                for leaf in _leaves(v, f"{prefix}/{k}" if prefix else k)]
    return [(prefix, tree)]


def log(what: str, since: float) -> None:
    print(f"setup: {what} at {time.perf_counter() - since:.3f} s",
          file=sys.stderr, flush=True)


def _step_grad(before: dict, after: dict, beta1: float, mu: float) -> dict:
    """A step's gradient as the optimisers took it, from their state around
    it: Adam's (m' - beta1 m) / (1 - beta1) for the alphas, the momentum
    buffer's b' - mu b for theta."""
    return {"alphas": _tmap(lambda m1, m0: (m1 - beta1 * m0) / (1 - beta1),
                            after["adam_m"], before["adam_m"]),
            "theta": _tmap(lambda b1, b0: b1 - mu * b0, after["momentum"],
                           before["momentum"])}


def _gaps(got: dict, want: dict, start: dict) -> tuple:
    """(loss gap, gradient gap, change gap) of steps from `start` (alphas
    and theta): the largest relative gap of a step's loss or validation
    loss; by the worst leaf, the gap between the two norms of the leaf's
    gradient (of its change from `start`) over the reference's norm of that
    leaf or of the median leaf, whichever is larger; the change leaves out
    leaves whose reference gradient is under a thousandth of the median
    leaf's."""
    loss_gap = max(abs(g - w) / abs(w)
                   for gs, ws in zip(got["losses"], want["losses"])
                   for g, w in zip(gs, ws))
    g_got = dict(_leaves(got["grad"]))
    gn_want = {k: float(v.norm()) for k, v in _leaves(want["grad"])}
    g_med = statistics.median(gn_want.values())
    grad_gap = max(abs(float(g_got[k].norm()) - gn_want[k])
                   / max(gn_want[k], g_med) for k in gn_want)
    start = dict(_leaves(start))
    moved = [k for k in gn_want if gn_want[k] >= 1e-3 * g_med]
    d_got = {k: float((v - start[k]).norm()) for k, v in _leaves(got["after"])}
    d_want = {k: float((v - start[k]).norm())
              for k, v in _leaves(want["after"])}
    d_med = statistics.median(d_want[k] for k in moved)
    change_gap = max(abs(d_got[k] - d_want[k]) / max(d_want[k], d_med)
                     for k in moved)
    return loss_gap, grad_gap, change_gap


class System:
    def __init__(self, cell, seed: int, device):
        self.cell = cell
        self.cfg, self.traffic = cell.config, cell.traffic
        self.net_opt, self.train_opt = (self.cfg["network_G"],
                                        self.cfg["train"])
        self.seed = seed
        self.device = torch.device(device)
        self.trace = None

    @contextlib.contextmanager
    def context(self):
        with tf32(self.cfg["tf32"]):
            yield

    def _pair(self, i: int):
        k = i % self.traffic["pairs"]
        b = self.batches
        return ({"noisy": b["noisy"][k, 0], "gt": b["gt"][k, 0]},
                {"noisy": b["noisy"][k, 1], "gt": b["gt"][k, 1]})

    def setup(self) -> None:
        from reconfigisp_tpu_torch import config
        from reconfigisp_tpu_torch.search.trainer import DartsTrainer
        from reconfigisp_tpu_torch.supernet import SuperNet

        dev = self.device
        t0 = time.perf_counter()
        opt = {"model": "darts", "network_G": self.net_opt,
               "train": self.train_opt}
        kw = config.supernet_kwargs(opt)
        self.n_step, self.use_proxies = kw["n_step"], kw["use_proxies"]
        self.threshold = kw["threshold"]
        net = SuperNet(**kw, device=dev)
        trainer = DartsTrainer(net, dict(self.train_opt))
        variables = trainer.variables

        gen = torch.Generator(device=dev).manual_seed(2 * self.seed + 1)
        kinds = zoo.modules(self.n_step, self.use_proxies)
        if set(kinds) != set(variables["omega"]):
            raise RuntimeError(f"the program's modules "
                               f"{sorted(variables['omega'])} are not the "
                               f"space's {sorted(kinds)}")
        proxies = {op: len(zoo.INIT_LOGITS[op]) for op, k in kinds.items()
                   if k == "srcnn_res"}
        self.omega = weights.draw_modules(gen, kinds, dev, proxies)
        self.theta0 = {slot: {op: torch.tensor(zoo.INIT_LOGITS[op],
                                               device=dev)
                              for op in ops if op in zoo.INIT_LOGITS}
                       for slot, ops in zoo.slots(self.n_step)}
        self.alphas0 = {slot: torch.zeros(len(ops), device=dev)
                        for slot, ops in zoo.slots(self.n_step)}
        with torch.no_grad():
            for op, module in variables["omega"].items():
                module.load_state_dict(weights.program_state_dict(
                    kinds[op], self.omega[op]))
            _tmap(lambda t, v: t.copy_(v), variables["theta"], self.theta0)
            _tmap(lambda t, v: t.copy_(v), variables["alphas"], self.alphas0)
        self.batches = self.cell.generator().make(self.traffic, self.seed,
                                                  dev)
        self.trainer = trainer
        self.radii = self._radii(self.theta0)
        _sync(dev)
        log("built the trainer, its state and the batches", t0)

        losses = []
        zero = _tmap(torch.zeros_like, trainer.opt_state)
        for i in range(CHECKED_STEPS):
            t0 = time.perf_counter()
            logs = trainer.search_step(*self._pair(i))
            _sync(dev)
            if i == 0:
                self.first_dispatch_s = time.perf_counter() - t0
                grad = self._grad(zero, trainer.opt_state)
            losses.append((logs["loss"], logs["val_loss"]))
            log(f"step {i + 1}", t0)
        self.program = {"losses": losses, "grad": grad,
                        "after": {k: _tmap(torch.clone, trainer.variables[k])
                                  for k in ("alphas", "theta")}}

    def window(self, seconds: float, trace: bool) -> dict:
        """Steps until `seconds` have passed, the pairs of the pool in turn
        after the checked ones; with `trace`, the traffic's profile_steps
        steps from the middle of the window are profiled.  One unprofiled
        step, drawn from the seed over all of them, is kept for the check
        (`self.kept`): its pair, its logs and the state around it."""
        rng = random.Random(self.seed)
        steps = failed = unprofiled = 0
        times, profiled = [], []
        self.kept = None
        start = time.perf_counter()

        def one(traced: bool = False):
            nonlocal steps, failed, unprofiled
            i = CHECKED_STEPS + steps
            keep = not traced and rng.randrange(unprofiled + 1) == 0
            before = self._state() if keep else None
            t0 = time.perf_counter()
            logs = self.trainer.search_step(*self._pair(i))
            times.append(time.perf_counter() - t0)
            if keep:
                self.kept = {"pair": i, "index": self.trainer.step_idx,
                             "before": before, "after": self._state(),
                             "losses": [(logs["loss"], logs["val_loss"])]}
            profiled.append(traced)
            unprofiled += not traced
            steps += 1
            failed += not math.isfinite(logs["loss"])

        while time.perf_counter() - start < seconds:
            if trace and self.trace is None and \
                    time.perf_counter() - start >= seconds / 2:
                n = self.traffic["profile_steps"]
                self.radii = self._radii(self.trainer.variables["theta"])
                self.trace = tracelib.capture(
                    lambda: [one(True) for _ in range(n)], self.device)
            else:
                one()
        _sync(self.device)
        return {"steps": steps, "window_s": time.perf_counter() - start,
                "step_s": times, "profiled": profiled, "attempted": steps,
                "failed": failed,
                "first_dispatch_s": self.first_dispatch_s}

    def _state(self) -> dict:
        """A copy of the trainer's alphas, theta and optimiser state."""
        tr = self.trainer
        return {"alphas": _tmap(torch.clone, tr.variables["alphas"]),
                "theta": _tmap(torch.clone, tr.variables["theta"]),
                "opt": _tmap(torch.clone, tr.opt_state)}

    def _grad(self, before: dict, after: dict) -> dict:
        return _step_grad(before, after, self.train_opt["beta1"],
                          self.train_opt["momentum_G"])

    def _radii(self, theta) -> dict:
        """{slot: {op: (window radius, block radius)}} of the windowed ops
        at theta (reference/ops.radius of their logits' sigmoids)."""
        out = {}
        for slot, ops in zoo.slots(self.n_step):
            for op in ops:
                if op not in RADIUS_PARAM or op not in theta[slot]:
                    continue
                p = torch.sigmoid(theta[slot][op].detach().float().cpu())
                block = (int(refops.radius(p[BLOCK_PARAM[op]]))
                         if op in BLOCK_PARAM else 0)
                out.setdefault(slot, {})[op] = (
                    int(refops.radius(p[RADIUS_PARAM[op]])), block)
        return out

    def work(self) -> dict:
        """The step's counted operations and the windowed ops' forward
        applications that it needs, at the radii of the profiled step (of
        the initial theta in a run that profiles none)."""
        t = self.traffic
        args = (self.n_step, self.use_proxies, t["batch"], t["crop"],
                self.radii)
        return {"flops_per_step": counts.search_step_flops(*args),
                "peak_flops": counts.PEAK_FLOPS["f32"],
                "windowed": counts.search_step_windowed(*args)}

    def release(self) -> None:
        self.trainer = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ the check

    def answers(self):
        out = dict(self.program)
        if self.kept is not None:
            k = self.kept
            out["window"] = {"losses": k["losses"],
                             "grad": self._grad(k["before"]["opt"],
                                                k["after"]["opt"]),
                             "after": {"alphas": k["after"]["alphas"],
                                       "theta": k["after"]["theta"]}}
        return out

    def modes(self) -> dict:
        return {"stated": "f32", "control": "tf32"}

    def reference(self, mode: str, batch_rows=None):
        """The reference in the program's place, in `mode`: 'f32' (TF32
        off) or 'tf32'; batch_rows keeps that many rows of each batch (the
        fault that leaves half of the batch out).  Its first steps from the
        initial state, and the kept window step from the program's state
        before it, in the form of answers()."""
        t = self.train_opt
        cfg = {"n_step": self.n_step, "threshold": self.threshold,
               "use_proxies": self.use_proxies, "lr": t["lr_G"],
               "momentum": t["momentum_G"], "lr_meta": t["lr_meta"],
               "beta1": t["beta1"], "beta2": t["beta2"],
               "batch_rows": batch_rows}
        state = refsearch.initial_state(
            _tmap(torch.clone, self.alphas0), _tmap(torch.clone, self.theta0),
            self.omega)
        with tf32(mode == "tf32"):
            out = refsearch.run(state, [self._batch(i)
                                        for i in range(CHECKED_STEPS)], cfg)
            if self.kept is not None:
                out["window"] = self._reference_step(cfg)
        return out

    def _batch(self, i: int) -> dict:
        train, val = self._pair(i)
        return {"img": train["noisy"], "gt": train["gt"],
                "val_img": val["noisy"], "val_gt": val["gt"]}

    def _reference_step(self, cfg: dict) -> dict:
        """The reference's step over the kept window step's pair, from the
        program's state before it.  The schedule's scale is 1 before its
        first milestone, which no window reaches."""
        k = self.kept
        if k["index"] >= min(self.train_opt["lr_steps"]):
            raise RuntimeError(f"window step {k['index']} is past the "
                               f"schedule's first milestone")
        b, opt = k["before"], k["before"]["opt"]
        state = {"alphas": b["alphas"], "theta": b["theta"],
                 "omega": self.omega, "buf": opt["momentum"],
                 "m": opt["adam_m"], "v": opt["adam_v"],
                 "t": int(opt["adam_t"])}
        new, logs = refsearch.darts_step(state, self._batch(k["pair"]), cfg)
        after = {"momentum": new["buf"], "adam_m": new["m"]}
        return {"losses": [(logs["loss"], logs["val_loss"])],
                "grad": self._grad(opt, after),
                "after": {"alphas": new["alphas"], "theta": new["theta"]}}

    def compare(self, got, want) -> dict:
        """loss_gap, grad_gap, change_gap: the first steps from the initial
        state (_gaps; the gradient is the first step's); step_loss_gap,
        step_grad_gap, step_change_gap: the kept window step from the state
        before it, None where either side has none."""
        start = {"alphas": self.alphas0, "theta": self.theta0}
        out = dict(zip(("loss_gap", "grad_gap", "change_gap"),
                       _gaps(got, want, start)))
        names = ("step_loss_gap", "step_grad_gap", "step_change_gap")
        if "window" in got and "window" in want:
            before = {k: self.kept["before"][k] for k in ("alphas", "theta")}
            out.update(zip(names, _gaps(got["window"], want["window"],
                                        before)))
        else:
            out.update(dict.fromkeys(names))
        return out

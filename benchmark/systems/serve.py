"""Serving system: full frames through the port's make_serving_fn.

Set-up draws the traffic's pool of mosaics and the pipeline's weights and
logits from the seed on the device, builds the port's Pipeline and serving
closure (deploy.make_serving_fn at the configuration's patch and stride,
the function's own chunk), and serves two frames to warm up.  The window is
a closed loop of one client: frame after frame from the pool, each timed on
the host from the call to its output after a synchronize.  A sample of the
window's frames, drawn from the seed over all of them (reservoir sampling),
is kept for the check, which runs the plain reference (reference/serve.py)
over the same mosaics with the same weights once the program is freed.
"""

from __future__ import annotations

import contextlib
import gc
import random
import sys
import time

import torch

from benchmark.lib import counts, weights
from benchmark.lib.device import tf32
from benchmark.lib import trace as tracelib
from benchmark.reference import serve as refserve
from benchmark.reference import zoo

CONTROL = {"f32": "tf32", "bf16": "fp8"}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def log(what: str, since: float) -> None:
    print(f"setup: {what} at {time.perf_counter() - since:.3f} s",
          file=sys.stderr, flush=True)


class System:
    def __init__(self, cell, seed: int, device):
        self.cell = cell
        self.cfg, self.traffic = cell.config, cell.traffic
        self.seed = seed
        self.device = torch.device(device)
        self.storage = self.cfg["cnn_storage"]
        self.trace = None

    @contextlib.contextmanager
    def context(self):
        """The configuration's precision around set-up and window: the CNN
        storage policy, TF32 as the configuration states."""
        from reconfigisp_tpu_torch import precision
        with precision.cnn_storage(self.storage), tf32(self.cfg["tf32"]):
            yield

    def setup(self) -> None:
        from reconfigisp_tpu_torch.deploy import make_serving_fn
        from reconfigisp_tpu_torch.pipeline import Pipeline

        cfg, dev = self.cfg, self.device
        t0 = time.perf_counter()
        self.pool = self.cell.generator().make(self.traffic, self.seed,
                                               dev)["pool"]
        _sync(dev)
        log("drew the pool", t0)
        gen = torch.Generator(device=dev).manual_seed(2 * self.seed + 1)
        arch = cfg["architecture"]
        ops = zoo.parse(arch)
        kinds = {op: zoo.module_kind(op, False) for op in ops
                 if zoo.module_kind(op, False)}
        proxies = {op: len(zoo.INIT_LOGITS[op]) for op, k in kinds.items()
                   if k == "srcnn_res"}
        self.weights = weights.draw_modules(gen, kinds, dev, proxies)
        self.logits = {i: weights.logits_near(gen, zoo.INIT_LOGITS[op],
                                              cfg["logit_spread"], dev)
                       for i, op in enumerate(ops) if op in zoo.INIT_LOGITS}

        pipe = Pipeline(arch, use_proxy=False, device=dev)
        if [spec.name for _, spec in pipe.steps] != ops:
            raise RuntimeError(f"the program parses {arch} as "
                               f"{[s.name for _, s in pipe.steps]}")
        state = {"logits": {pipe.steps[i][0]: v
                            for i, v in self.logits.items()},
                 "weights": {op: weights.program_state_dict(kind,
                                                            self.weights[op])
                             for op, kind in kinds.items()}}
        self.pipe = pipe.load_state(state)
        self.serve = make_serving_fn(pipe, patch=cfg["patch"],
                                     stride=cfg["stride"], device=dev)
        log("built the pipeline", t0)
        for i in range(2):
            self.serve(self.pool[i % len(self.pool)])
            _sync(dev)
            log(f"warm-up frame {i + 1}", t0)

    def _frame(self, i: int):
        x = self.pool[i % len(self.pool)]
        t0 = time.perf_counter()
        y = self.serve(x)
        _sync(self.device)
        return time.perf_counter() - t0, y

    def window(self, seconds: float, trace: bool) -> dict:
        """Frames until `seconds` have passed; with `trace`, the
        traffic's profile_frames frames from the middle of the window are
        profiled (tracelib.capture)."""
        rng = random.Random(self.seed)
        keep = self.traffic["checked_frames"]
        times, profiled, self.kept = [], [], []
        start = time.perf_counter()
        i = 0

        def serve_one(traced: bool):
            nonlocal i
            dt, y = self._frame(i)
            times.append(dt)
            profiled.append(traced)
            if len(self.kept) < keep:
                self.kept.append((i % len(self.pool), y))
            else:
                j = rng.randrange(i + 1)
                if j < keep:
                    self.kept[j] = (i % len(self.pool), y)
            i += 1

        while time.perf_counter() - start < seconds:
            if trace and self.trace is None and \
                    time.perf_counter() - start >= seconds / 2:
                n = self.traffic["profile_frames"]
                self.trace = tracelib.capture(
                    lambda: [serve_one(True) for _ in range(n)], self.device)
            else:
                serve_one(False)
        h, w = self.pool.shape[2:4]
        return {"frame_s": times, "profiled": profiled,
                "window_s": time.perf_counter() - start, "frames": i,
                "mp_per_frame": h * w / 1e6, "attempted": i, "failed": 0}

    def work(self) -> dict:
        h, w = self.pool.shape[2:4]
        return {"flops_per_frame": counts.serve_frame_flops(
                    self.cfg["architecture"], h, w, self.cfg["patch"],
                    self.cfg["stride"]),
                "peak_flops": counts.PEAK_FLOPS[self.storage]}

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.serve = self.pipe = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ the check

    def answers(self):
        return self.kept

    def modes(self) -> dict:
        return {"stated": self.storage, "control": CONTROL[self.storage]}

    def reference(self, mode: str):
        """The reference's frames for the kept ones, in `mode`: 'f32' and
        'bf16' with TF32 off, 'tf32' (f32 with TF32 on), 'fp8'."""
        storage = "f32" if mode == "tf32" else mode
        with tf32(mode == "tf32"):
            return [(p, refserve.serve_frame(
                self.cfg["architecture"], self.pool[p], self.weights,
                self.logits, patch=self.cfg["patch"],
                stride=self.cfg["stride"], storage=storage))
                for p, _ in self.kept]

    @staticmethod
    def compare(got, want) -> dict:
        """Widest and mean absolute gap of the served frames' values."""
        gaps = [(a.float() - b.float()).abs() for (_, a), (_, b)
                in zip(got, want)]
        return {"max_abs": max(float(g.max()) for g in gaps),
                "mean_abs": sum(float(g.mean()) for g in gaps) / len(gaps)}

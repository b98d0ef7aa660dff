#!/usr/bin/env python3
"""What the plain forms' reflect padding costs on one GPU, three ways.

    python3 tools/time_torch_padding.py

The plain PyTorch forms (ops/kernels/{bilateral,median,fastnlm}.py) pad by
reflection: once per call for the bilateral and the median, and for fast
NLM once for the image and twice per search offset in its box filter.  On
the card they are the kernels' reference and the forward that every
training backward recomputes (ops/kernels/_vjp.py).  Three paddings, each
put in the modules' `pad_reflect` and `reflect` for its rounds:

  slices  flipped slices joined on with torch.cat, the bilateral's and the
          median's on NHWC: a backward that adds in a fixed order, about
          three launches a dimension forward;
  fpad2d  F.pad(mode="reflect") over both dimensions at once (fast NLM's
          image one dimension at a time): one launch, but its CUDA backward
          adds with atomics, up to four addends at a corner;
  fpad1d  F.pad(mode="reflect") one dimension at a time, on NCHW: an input
          value gets at most two addends a pass (itself and one mirror
          image) while the dimension is longer than 2r + 1, and a sum of
          two is the same in either order.

Rounds run in the order fpad2d, slices, fpad1d, fpad1d, slices, fpad2d, in
one process, TF32 off.  Each prints, per padding:
  - each plain form's forward at chip_smoke.py phase 6's (8, 512, 512, 3),
    every radius 4 (CUDA events, 3 calls after a warm-up);
  - ms per train step and peak memory of chip_smoke.py phase 7 (SID_isp's
    options and batch) on slice 1 and slice 2, with the kernels (whose
    backward recomputes the plain form) and with the plain forms;
  - whether three gradients of each plain form, for x and params, on the
    same (4, 192, 192, 3) inputs are equal bit for bit, and the strides of
    the bilateral's padded tensor.
Exits 1 without CUDA.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (BANK, KERNELS, PATHS, _train_run,  # noqa: E402
                        event_ms, kernel_params, line, make_trainer,
                        make_training_batch, nvidia_smi, sid_isp_options,
                        tf32_off)
from reconfigisp_tpu_torch.ops.kernels import _build  # noqa: E402
from reconfigisp_tpu_torch.ops.kernels import bilateral as kb  # noqa: E402
from reconfigisp_tpu_torch.ops.kernels import fastnlm as kf  # noqa: E402
from reconfigisp_tpu_torch.ops.kernels import median as km  # noqa: E402
from reconfigisp_tpu_torch.utils.checkpoint import load_network  # noqa: E402

ORDER = ("fpad2d", "slices", "fpad1d", "fpad1d", "slices", "fpad2d")


def reflect_slices(x, r, dim):
    n = x.shape[dim]
    return torch.cat([x.narrow(dim, 1, r).flip(dim), x,
                      x.narrow(dim, n - 1 - r, r).flip(dim)], dim)


def reflect_fpad(x, r, dim):
    """F.pad's reflect along one of the last two dimensions of a 4-D x."""
    pad = (r, r, 0, 0) if dim == x.ndim - 1 else (0, 0, r, r)
    return F.pad(x, pad, mode="reflect")


def pad_slices(x, r):
    return reflect_slices(reflect_slices(x, r, 1), r, 2)


def pad_fpad2d(x, r):
    return F.pad(x.permute(0, 3, 1, 2), (r,) * 4,
                 mode="reflect").permute(0, 2, 3, 1)


def pad_fpad1d(x, r):
    nchw = x.permute(0, 3, 1, 2)
    return reflect_fpad(reflect_fpad(nchw, r, 2), r, 3).permute(0, 2, 3, 1)


# padding -> (NHWC pad of the bilateral and the median, per-dimension
# reflect of fast NLM)
PADDINGS = {"slices": (pad_slices, reflect_slices),
            "fpad2d": (pad_fpad2d, reflect_fpad),
            "fpad1d": (pad_fpad1d, reflect_fpad)}


def use(padding: str) -> None:
    pad, reflect = PADDINGS[padding]
    kb.pad_reflect = km.pad_reflect = pad
    kf.reflect = reflect


def forward_times(dev, padding: str) -> None:
    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.rand((8, 512, 512, 3), generator=gen, device=dev)
    for name, (_, plain, *_) in KERNELS.items():
        p = kernel_params(name, [4] * 8, dev)
        if name == "fastnlm":
            p[:, 2] = 0.5
        ms = event_ms(lambda: plain(x, p), reps=3)
        line("padding plain forward", padding=padding, kernel=name,
             shape=tuple(x.shape), radius=4, ms=f"{ms:.5f}")


def train_times(dev, padding: str, bank, options) -> None:
    _, use_proxy, train_opt, n, size = options
    batch = make_training_batch(dev, n, size)
    for arch in PATHS:
        for plain in (False, True):
            run = _train_run(make_trainer(dev, arch, use_proxy, bank,
                                          train_opt, plain), batch)
            line("padding train step", padding=padding, arch=arch,
                 mode="plain" if plain else "kernels",
                 ms_per_step=f"{run['ms']:.3f}",
                 peak_mib=f"{run['peak_bytes'] / 2**20:.1f}",
                 loss_last=f"{run['losses'][-1]:.9f}")


def determinism(dev, padding: str) -> None:
    gen = torch.Generator(device=dev).manual_seed(4)
    shape = (4, 192, 192, 3)
    for name, (_, plain, *_) in KERNELS.items():
        x = torch.rand(shape, generator=gen, device=dev)
        g = torch.randn(shape, generator=gen, device=dev)
        p = kernel_params(name, (4, 5, 6, 7), dev)
        runs = []
        for _ in range(3):
            xs, ps = x.clone().requires_grad_(), p.clone().requires_grad_()
            runs.append(torch.autograd.grad(plain(xs, ps), (xs, ps), g,
                                            allow_unused=True))
        same = all(torch.equal(a, b) for run in runs[1:]
                   for a, b in zip(run, runs[0]) if a is not None)
        line("padding gradient", padding=padding, kernel=name, shape=shape,
             runs=3, bit_equal=same)
    strides = PADDINGS[padding][0](torch.rand(shape, device=dev), 7).stride()
    line("padding layout", padding=padding, bilateral_padded_strides=strides)


def main() -> int:
    if not torch.cuda.is_available():
        print("time_torch_padding: CUDA is not available", file=sys.stderr)
        return 1
    tf32_off()
    dev = torch.device("cuda")
    print(f"nvidia-smi: {nvidia_smi()}", flush=True)
    _build.build(list(KERNELS))
    bank = load_network(str(BANK))
    options = sid_isp_options()
    shipped = (kb.pad_reflect, km.pad_reflect, kf.reflect)
    try:
        for padding in ORDER:
            use(padding)
            forward_times(dev, padding)
            train_times(dev, padding, bank, options)
            determinism(dev, padding)
    finally:
        kb.pad_reflect, km.pad_reflect, kf.reflect = shipped
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (reconfigisp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each:
  1. environment: versions, device, nvidia-smi's name and power limit;
  2. build every CUDA kernel of the path from csrc/ with nvcc (sm_90a);
  3. each kernel against its plain PyTorch form on the card;
  4. the SID serving path Bayer_01_Demosaic_03_sRGB_07_01_13_11 end to end on
     two 2848x4256 frames (patch 512, stride 480, chunk 8), with the kernel
     launches counted, and its output against the same path with the plain
     forms on the same two frames;
  5. times with CUDA events, and each kernel's bound.
Then one JSON line with the kernels and, last, the device line.  Every check
raises on failure; without CUDA the script exits 1 before printing a result.
tools/profile_torch_serving.py imports the serving set-up from here.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

from reconfigisp_tpu_torch import Pipeline, convert, precision
from reconfigisp_tpu_torch.deploy import make_serving_fn
from reconfigisp_tpu_torch.ops.kernels import _build
from reconfigisp_tpu_torch.ops.kernels import bilateral as kb
from reconfigisp_tpu_torch.parallel.tiling import tile_positions
from reconfigisp_tpu_torch.utils.checkpoint import load_network

ROOT = Path(__file__).resolve().parent
ARCH = "Bayer_01_Demosaic_03_sRGB_07_01_13_11"
FRAME = (2848, 4256)   # Sony frame of SID, 12.1 MP
PATCH, STRIDE, CHUNK = 512, 480, 8
KERNEL_TOL = 2e-5      # kernel vs plain form: expf in both, sums reordered
E2E_TOL = 1e-4         # whole path, kernel vs plain bilateral, TF32 off
BF16_TOL = 5e-2        # whole path, bf16 vs f32 CNN storage: 8-bit mantissa
                       # through 14 conv layers

# Published H100 SXM peaks (NVIDIA data sheet), for the bounds: device memory
# 3.35 TB/s; FP32 67 TFLOP/s; exp on the special-function units: 16 per clock
# per SM (CUDA programming guide, compute capability 9.0) x 132 SMs x 1.98 GHz.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
SFU_EXP_PER_S = 16 * 132 * 1.98e9


def line(phase: str, **fields) -> None:
    print(f"{phase}: " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def event_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps calls, after one warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def radius_params(radii, dev) -> torch.Tensor:
    """(N, 3) bilateral params: the given radii, a distinct sigma pair each."""
    rows = [[(r - 0.5) / 7.0, 0.05 + 0.09 * i, 0.1 + 0.08 * i]
            for i, r in enumerate(radii)]
    return torch.tensor(rows, dtype=torch.float32, device=dev)


def bilateral_bound_ms(x: torch.Tensor, params: torch.Tensor) -> float:
    """Least time for the bilateral on these inputs.  Bytes: each input read
    and the output written once.  Operations, over each image's own window of
    (2r+1)^2 taps per pixel and channel: the colour weight is symmetric,
    w(p, q) = w(q, p), and 1 at the centre, so ((2r+1)^2 - 1) / 2 distinct
    exps, each with 3 FP32 operations for its argument (difference, square,
    scale); then 4 per tap (the two weights' product, an FMA into the
    numerator, an add into the denominator)."""
    n, h, w, c = x.shape
    radii = kb.size01_to_radius(params[:, 0]).tolist()
    taps = sum((2 * r + 1) ** 2 for r in radii) * h * w * c
    exps = sum(((2 * r + 1) ** 2 - 1) // 2 for r in radii) * h * w * c
    moved = 2 * x.numel() * 4 + params.numel() * 4
    return 1e3 * max(moved / HBM_BYTES_PER_S,
                     (4 * taps + 3 * exps) / FP32_FLOP_PER_S,
                     exps / SFU_EXP_PER_S)


def nvidia_smi(index: int = 0) -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[index]


def tf32_off() -> None:
    """True f32 convolutions and matmuls."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def load_pipeline(dev) -> Pipeline:
    """The slice's pipeline: path_bayer from the in-repo bank, init logits."""
    bank = load_network(str(ROOT / "experiments" / "proxies" / "default.ckpt"))
    pipe = Pipeline(ARCH, device=dev)
    return pipe.load_state(convert.state_from_jax(
        {"weights": {"path_bayer": bank["path_bayer"]}}))


def make_frames(dev) -> torch.Tensor:
    """Two SID-size Bayer mosaics in [0, 1], made on the card from seed 0."""
    gen = torch.Generator(device=dev).manual_seed(0)
    return torch.rand((2, *FRAME, 1), generator=gen, device=dev)


def make_serve(pipe, dev):
    return make_serving_fn(pipe, patch=PATCH, stride=STRIDE, chunk=CHUNK,
                           device=dev)


def phase_environment(dev) -> None:
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = "absent"
    smi = nvidia_smi(dev.index or 0)
    line("phase 1 environment", torch=torch.__version__,
         cuda=torch.version.cuda, triton=triton_version,
         device=repr(torch.cuda.get_device_name(dev)),
         count=torch.cuda.device_count())
    print(f"nvidia-smi: {smi}", flush=True)


def phase_build() -> None:
    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    report = _build.build(sources)
    for name in sources:
        if name in report:
            secs, output = report[name]
            ptxas = [ln.strip() for ln in output.splitlines()
                     if "registers" in ln or "spill" in ln]
            line("phase 2 build", kernel=name, seconds=f"{secs:.2f}",
                 ptxas=repr(" | ".join(ptxas)))
        else:
            line("phase 2 build", kernel=name, seconds=0, cached=True)
        _build.load(name)


def phase_kernels(dev) -> float:
    gen = torch.Generator(device=dev).manual_seed(1)
    cases = {
        "tiles_8x512x512x3_r1-7": ((8, 512, 512, 3), [1, 2, 3, 4, 5, 6, 7, 4]),
        "tiles_8x512x512x1_r1-7": ((8, 512, 512, 1), [1, 2, 3, 4, 5, 6, 7, 4]),
        "frame_2x520x776x3_r3,7": ((2, 520, 776, 3), [3, 7]),
    }
    worst = 0.0
    for name, (shape, radii) in cases.items():
        x = torch.rand(shape, generator=gen, device=dev)
        p = radius_params(radii, dev)
        got = kb.bilateral(x, p)
        want = kb.bilateral_plain(x, p)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        line("phase 3 kernel vs plain", kernel="bilateral", case=name,
             max_abs_err=f"{err:.3e}", tol=KERNEL_TOL)
        if not err <= KERNEL_TOL:
            raise AssertionError(f"bilateral {name}: {err} > {KERNEL_TOL}")
        worst = max(worst, err)
    return worst


def _with_plain_bilateral(pipe):
    """The same pipeline object with its bilateral step on the plain form."""
    steps = list(pipe.steps)
    for i, (name, spec) in enumerate(steps):
        if spec.name == "bilateral":
            steps[i] = (name, dataclasses.replace(
                spec, apply=lambda x, p, w: kb.bilateral_plain(x, p)))
    return steps


def phase_serving(dev, pipe, frames) -> int:
    serve = make_serve(pipe, dev)
    n_tiles = (len(tile_positions(FRAME[0], PATCH, STRIDE))
               * len(tile_positions(FRAME[1], PATCH, STRIDE)))
    chunks = math.ceil(n_tiles / CHUNK)

    kb.launches = 0
    y = serve(frames)
    torch.cuda.synchronize()
    launches = kb.launches
    if tuple(y.shape) != (frames.shape[0], *FRAME, 3):
        raise AssertionError(f"output shape {tuple(y.shape)}")
    if not bool(torch.isfinite(y).all()):
        raise AssertionError("non-finite output")
    lo, hi = float(y.min()), float(y.max())
    if lo < 0.0 or hi > 1.0:
        raise AssertionError(f"output outside [0, 1]: {lo}..{hi}")
    if launches != chunks:
        raise AssertionError(f"bilateral launches {launches} != {chunks} chunks")
    line("phase 4 serving", arch=ARCH, frames=tuple(frames.shape),
         out=tuple(y.shape), tiles_per_frame=n_tiles, chunks=chunks,
         bilateral_launches=launches, range=f"{lo:.4f}..{hi:.4f}")

    # the main path's own output, whose kernel batches are (16, 512, 512, 3)
    # and a last (12, 512, 512, 3), against the plain form on the same frames
    kernel_steps, pipe.steps = pipe.steps, _with_plain_bilateral(pipe)
    try:
        y_plain = serve(frames)
    finally:
        pipe.steps = kernel_steps
    torch.cuda.synchronize()
    diff = float((y - y_plain).abs().max())
    line("phase 4 kernel vs plain end to end", frames=tuple(frames.shape),
         max_abs_diff=f"{diff:.3e}", tol=E2E_TOL,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32)
    if not diff <= E2E_TOL:
        raise AssertionError(f"end to end kernel vs plain: {diff} > {E2E_TOL}")
    return launches


def phase_times(dev, pipe, frames) -> dict:
    serve = make_serve(pipe, dev)
    n = frames.shape[0]
    mp = n * FRAME[0] * FRAME[1] / 1e6
    outs = {}
    for storage in ("f32", "bf16"):
        with precision.cnn_storage(storage):
            ms = event_ms(lambda: serve(frames), reps=2)
            outs[storage] = serve(frames[:1])
        line("phase 5 serving time", storage=storage, ms_per_frame=f"{ms / n:.3f}",
             mp_per_s=f"{mp / (ms / 1e3):.3f}",
             cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    diff = float((outs["bf16"] - outs["f32"]).abs().max())
    line("phase 5 bf16 vs f32 storage", frame=tuple(outs["f32"].shape),
         max_abs_diff=f"{diff:.3e}", tol=BF16_TOL)
    if not diff <= BF16_TOL:  # also false for a NaN
        raise AssertionError(f"bf16 vs f32 storage: {diff} > {BF16_TOL}")

    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.rand((8, PATCH, PATCH, 3), generator=gen, device=dev)
    p = radius_params([4] * 8, dev)
    ms = event_ms(lambda: kb.bilateral(x, p), reps=20)
    plain_ms = event_ms(lambda: kb.bilateral_plain(x, p), reps=3)
    bound = bilateral_bound_ms(x, p)
    line("phase 5 kernel time", kernel="bilateral", shape=tuple(x.shape),
         radius=4, ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
         bound_ms=f"{bound:.4f}", bound_by="operations", library_ms=None)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", torch.cuda.current_device())
    tf32_off()

    phase_environment(dev)
    phase_build()
    max_err = phase_kernels(dev)

    pipe = load_pipeline(dev)
    frames = make_frames(dev)
    launches = phase_serving(dev, pipe, frames)
    times = phase_times(dev, pipe, frames)

    kernels = [{
        "name": "bilateral", "route": "cuda",
        "source": "reconfigisp_tpu_torch/csrc/bilateral.cu",
        "replaces": "reconfigisp_tpu/ops/pallas_kernels.py:113",
        "launches": launches, "max_abs_err": max_err,
        "ms": times["ms"], "plain_ms": times["plain_ms"],
        "bound_ms": times["bound_ms"], "bound_by": "operations",
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

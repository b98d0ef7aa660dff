#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (reconfigisp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each:
  1. environment: versions, device, nvidia-smi's name and power limit;
  2. build every CUDA kernel of csrc/ with nvcc (sm_90a), all at once, and
     beside them one kernel per radius and C of csrc/median.cu and of
     csrc/bilateral.cu: ptxas's registers and spills of each body and, where
     cuobjdump is present, its count of integer min/max instructions beside
     the pruned network's (median) and of MUFU.EX2 beside the design's
     (bilateral);
  3. each kernel against its plain PyTorch form on the card: bilateral and
     median at radii 1-7, fast NLM at block radii 1-7 with per-image search
     radii 1-7; C = 3 and C = 1, a ragged 520x776 frame, phase 7's
     4x192x192 training batch and phase 8's 4x48x48x3 search batch; the median and the bilateral also on
     saturated input (runs of exact 0 and 1), the bilateral on constant
     input and at both sigma extremes;
  4. the two serving paths end to end on two 2848x4256 frames (patch 512,
     stride 480, chunk 8): the SID path with bilateral,
     Bayer_01_Demosaic_03_sRGB_07_01_13_11, and with median then fast NLM,
     Bayer_01_Demosaic_03_sRGB_08_09_01_13_11.  Each is driven with every
     launch count set to 0 just before it and read just after, and its output
     is held against the same path with the plain forms on the same frames;
  5. the zoo: every op of the three pools, native and (where it has one)
     proxy, with the bank's weights, on a small input on the card against
     the same pipeline on the CPU;
  6. times with CUDA events: each path at f32 and bf16 CNN storage, the
     median and bilateral kernels at (8, 512, 512, 3) and every radius 1-7,
     and each kernel there with every radius 4, beside its bound;
  7. step-2 training (search.IspTrainer) as configs/SID_isp.yaml sets it
     (batch 4 of 192x192 crops, l2, Adam, MultiStepLR), read through the
     port's config.parse, on one batch made on the card from seed 0: the
     flagship Bayer_01_Demosaic_03_sRGB_01_13_11 and both paths above, 8
     steps each from the same start with the kernels and with the plain
     forms, the launches counted; the loss must fall and the two runs'
     losses and logits agree.  Then each kernel's gradient through its
     autograd Function against the plain form's: bit for bit where the
     backward is direct (the training batch and the search batch
     4x48x48x3), within STRIP_TOL where it goes by strips;
  8. step-1 search: the per-op latency table at 1024x1024 (native and
     proxy ops), installed; then configs/SID_search.yaml through the port's
     config.parse (3 sRGB slots of 15 ops, native, batch 4 of 48x48 crops,
     omega from the bank) on a planted train and val batch made on the card
     from seed 0: 6 second-order DARTS steps with the kernels, with the
     plain forms (losses, alphas and theta held within SEARCH_*_TOL) and
     with the kernels and remat off, the launches counted and steps 3-6
     timed; the argmax architecture served by Pipeline; 6 first-order steps
     at configs/planted_search.yaml's rates (the loss must fall); and
     DartsFtTrainer at configs/planted_search_ft.yaml, 3 steps and one
     finetune_proxies, whose targets launch the kernels.
Then one JSON line with the kernels and, last, the device line.  Every check
raises on failure; without CUDA the script exits 1 before printing a result.
The tools/profile_torch_*.py and tools/time_torch_padding.py scripts import
their set-up from here.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch
import torch.nn.functional as F

from reconfigisp_tpu_torch import Pipeline, config, convert, pool, precision
from reconfigisp_tpu_torch.deploy import make_serving_fn
from reconfigisp_tpu_torch.ops.kernels import _build
from reconfigisp_tpu_torch.ops.kernels import bilateral as kb
from reconfigisp_tpu_torch.ops.kernels import fastnlm as kf
from reconfigisp_tpu_torch.ops.kernels import median as km
from reconfigisp_tpu_torch.parallel.tiling import tile_positions
from reconfigisp_tpu_torch.ops import color, demosaic
from reconfigisp_tpu_torch.ops.kernels import _vjp
from reconfigisp_tpu_torch.search import DartsFtTrainer, DartsTrainer, IspTrainer
from reconfigisp_tpu_torch.supernet import SuperNet
from reconfigisp_tpu_torch.utils import latency
from reconfigisp_tpu_torch.utils.checkpoint import load_network

ROOT = Path(__file__).resolve().parent
BANK = ROOT / "experiments" / "proxies" / "default.ckpt"
SID_ISP = ROOT / "configs" / "SID_isp.yaml"
SID_SEARCH = ROOT / "configs" / "SID_search.yaml"
PLANTED_SEARCH = ROOT / "configs" / "planted_search.yaml"
PLANTED_SEARCH_FT = ROOT / "configs" / "planted_search_ft.yaml"
SLICE1 = "Bayer_01_Demosaic_03_sRGB_07_01_13_11"   # bilateral
SLICE2 = "Bayer_01_Demosaic_03_sRGB_08_09_01_13_11"   # median, fast NLM
PATHS = {SLICE1: ("bilateral",), SLICE2: ("median", "fastnlm")}
FRAME = (2848, 4256)   # Sony frame of SID, 12.1 MP
PATCH, STRIDE, CHUNK = 512, 480, 8
E2E_TOL = 1e-4         # whole path, kernels vs plain forms, TF32 off
ZOO_TOL = 1e-4         # one op on the card vs on the CPU: conv sums reordered
BF16_TOL = 5e-2        # whole path, bf16 vs f32 CNN storage: 8-bit mantissa
                       # through 14 conv layers
TRAIN_STEPS, TRAIN_WARMUP = 8, 2   # steps per run; untimed first steps
# Logits after TRAIN_STEPS steps, kernels vs plain forms.  The backward is
# the plain form's on the same saved inputs, so the runs part only by the
# kernels' forward error (at most 2e-5 bilateral, 0 median, 5e-5 fast NLM)
# in values of order 0.1-1 downstream: a relative change of at most about
# 5e-4 in each gradient.  Adam's step is lr times a ratio of moments that a
# common scale of the gradients leaves unchanged, so that moves a logit by
# about lr 5e-4 = 5e-7 a step, 4e-6 over 8 steps; the tolerance leaves 25x.
TRAIN_LOGIT_TOL = 1e-4
# Each step's loss, kernels vs plain forms, relative to the loss.  The loss
# (about 0.07) is a mean over n = 4 x 192 x 192 x 3 = 442,368 squared
# residuals r (|r| about 0.26); the kernels' forward errors are differences
# of rounding order, of either sign, at most 5e-5, so even at that size
# everywhere they move the mean by about 2 x 5e-5 x 0.26 / sqrt(n) = 4e-8,
# 6e-7 of the loss; an error of 1e-4 that follows the residual's sign moves
# it by 2 x 1e-4 x 0.26 = 5e-5, 7e-4 of it.
TRAIN_LOSS_RTOL = 1e-6
# Gradients by strips against the direct plain gradient: the same arithmetic
# on slabs of rows, so the input gradient differs only where two slabs' parts
# are added (1e-5); the params' gradient, a sum over the frame, in another
# order (1e-5 of its largest value).
STRIP_TOL = 1e-5
# (case, x shape, radius per image, fast-NLM block radius) of the gradient
# check: SID_isp's training batch and SID_search's search batch, whose 192
# and 48 rows take the direct backward, and a 1024-row frame at radius 7,
# which goes by strips
GRAD_CASES = (("direct", (4, 192, 192, 3), (4, 5, 6, 7), 4),
              ("search", (4, 48, 48, 3), (1, 3, 5, 7), 4),
              ("strip", (1, 1024, 768, 3), (7,), 7))

# Phase 8.  Steps per search run, and the untimed first steps.
SEARCH_STEPS, SEARCH_WARMUP = 6, 2
FT_SEARCH_STEPS = 3          # DartsFtTrainer's steps before finetune_proxies
LATENCY_SIZE = 1024          # frames of the latency table, batch 1
# The planted workload of configs/planted_search.yaml, the port's own copy of
# its constants (reconfigisp_tpu/data/datasets.py:265-270): the camera's BGR
# cast, the planted wb_manual and gamma params in [0, 1], the noise.
PLANTED_CAST = (0.8, 1.0, 0.6)
PLANTED_WB01 = tuple(1.0 / c / 5.0 for c in PLANTED_CAST)
PLANTED_GAMMA01 = 0.5 - math.log(2.2) / (2.0 * math.log(3.0))
PLANTED_SHOT, PLANTED_READ = 0.08, 0.02
# Kernels vs plain forms over 6 second-order steps, written before the first
# run.  In each forward the kernels differ from the plain forms by rounding
# order, at most 2e-5 (bilateral) and 5e-5 (fast NLM) a value, 0 (median),
# in candidates weighted 1/15 in each of 3 slots: an output error of at most
# about 1e-5, of either sign from value to value.
#  * Losses, relative: a mean over n = 27,648 squared residuals r (|r| about
#    0.3, loss about 0.05) moves by about 2 |r| 1e-5 / sqrt(n) = 4e-8, under
#    1e-6 of the loss; SEARCH_LOSS_RTOL leaves 10x.
#  * Alphas: Adam moves an alpha by lr m_hat / (sqrt(v_hat) + 1e-8), which a
#    relative error e of the gradient moves by about lr e; the alpha
#    gradients' e is about 1e-4 (the output error over values of 0.1-1; the
#    Hessian term's probes, 0.01 apart in theta, difference two passes of
#    the same error, and enter times lr_meta / (2 eps) <= 5e-3), so 6 steps at
#    lr 1e-4 move an alpha by 6e-8; SEARCH_ALPHA_TOL leaves 100x.  A
#    component whose gradient lies within its own error of zero could flip
#    Adam's sign and part by up to 2 lr a step: that would fail the check
#    and be looked into, not tolerated.
#  * Theta: SGD moves a logit by lr buf, buf a momentum sum of gradients of
#    at most about 1 with e about 1e-4: 6 x 1e-4 x 1e-4 = 6e-8;
#    SEARCH_THETA_TOL leaves 16x.
SEARCH_LOSS_RTOL = 1e-5
SEARCH_ALPHA_TOL = 1e-5
SEARCH_THETA_TOL = 1e-6

# name -> (module, plain form, params per image, tolerance against the plain
# form, TPU kernel it replaces).  Tolerances: bilateral takes one exp2 per
# tap of values staged times sqrt(kc) where the plain form multiplies two
# expf; fast NLM sums its boxes in another order and takes exp2 of the box
# sum times one folded scale; the median selects one of the input values,
# so it is exact.
KERNELS = {
    "bilateral": (kb, kb.bilateral_plain, 3, 2e-5,
                  "reconfigisp_tpu/ops/pallas_kernels.py:113"),
    "median": (km, km.median_plain, 1, 0.0,
               "reconfigisp_tpu/ops/pallas_kernels.py:218"),
    "fastnlm": (kf, kf.fastnlm_plain, 3, 5e-5,
                "reconfigisp_tpu/ops/pallas_kernels.py:324"),
}

# Integer min/max instructions of csrc/median.cu's pruned selection networks
# for one 2x2 block of pixels and one channel, by radius (its source note;
# tests/test_torch_windowed.py counts them in its mirror of the networks).
# Larger radii bisect.
MEDIAN_NETWORK_MINMAX = {1: 114, 2: 412, 3: 952, 4: 1724}

# csrc/bilateral.cu: output rows a thread owns.  A body's SASS holds one
# column offset's taps, BILATERAL_ROWS (2R+1) C MUFU.EX2 (its loop over the
# 2R+1 column offsets is not unrolled), so a thread issues (2R+1)^2 C of
# them per output row: one exp per tap.
BILATERAL_ROWS = 8

# Published H100 SXM peaks (NVIDIA data sheet), for the bounds: device memory
# 3.35 TB/s; FP32 67 TFLOP/s; exp on the special-function units: 16 per clock
# per SM (CUDA programming guide, compute capability 9.0) x 132 SMs x 1.98 GHz.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
SFU_EXP_PER_S = 16 * 132 * 1.98e9


def line(phase: str, **fields) -> None:
    print(f"{phase}: " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def _zero_counts() -> None:
    for mod, *_ in KERNELS.values():
        mod.launches = 0


def _counts() -> dict:
    return {name: mod.launches for name, (mod, *_) in KERNELS.items()}


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


def size01(radius: int) -> float:
    """A [0, 1] parameter whose mapped radius is `radius`."""
    return (radius - 0.5) / 7.0


def kernel_params(name: str, radii, dev, block: int = 4,
                  sigma=None) -> torch.Tensor:
    """(N, P) params for one kernel, one row per image.  bilateral: the
    given radii, a distinct sigma pair each, or both sigma01 = `sigma`;
    median: the radius of row 0 serves the batch; fastnlm: block radius
    `block` (from row 0), the given search radii, a distinct decay each."""
    if name == "bilateral" and sigma is not None:
        rows = [[size01(r), sigma, sigma] for r in radii]
    elif name == "bilateral":
        rows = [[size01(r), 0.05 + 0.09 * i, 0.1 + 0.08 * i]
                for i, r in enumerate(radii)]
    elif name == "median":
        rows = [[size01(r)] for r in radii]
    else:
        rows = [[size01(block), size01(r), 0.1 + 0.11 * i]
                for i, r in enumerate(radii)]
    return torch.tensor(rows, dtype=torch.float32, device=dev)


def _bound(moved_bytes: float, flops: float, exps: float):
    """(ms, 'bytes' or 'operations'): the larger of the bytes over the memory
    rate and the operations over their peak rates."""
    by_bytes = moved_bytes / HBM_BYTES_PER_S
    by_ops = max(flops / FP32_FLOP_PER_S, exps / SFU_EXP_PER_S)
    return 1e3 * max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                         else "operations")


def bilateral_bound(x: torch.Tensor, params: torch.Tensor):
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
    return _bound(moved, 4 * taps + 3 * exps, exps)


def median_bound(x: torch.Tensor, params: torch.Tensor):
    """Least time for the median on these inputs.  Bytes: each input read
    and the output written once.  Operations: every one of the K = (2r+1)^2
    taps must be looked at, so at least K - 1 comparisons per pixel and
    channel (r from params[0, 0] for the batch)."""
    r = int(kb.size01_to_radius(params[0, 0]))
    flops = ((2 * r + 1) ** 2 - 1) * x.numel()
    moved = 2 * x.numel() * 4 + params.numel() * 4
    return _bound(moved, flops, 0)


def fastnlm_bound(x: torch.Tensor, params: torch.Tensor):
    """Least time for fast NLM on these inputs.  Bytes: each input read and
    the output written once.  Operations, per pixel and channel over each
    image's own search window: D_o at p equals D_-o at p + o, so the box and
    the weight of ((2s+1)^2 - 1) / 2 distinct offsets (the centre's weight is
    1).  Each costs the difference and its square (2), the box with running
    sums (an add and a subtract in each direction, 1 scale: 5), the exp's
    argument (1) and one exp, and the weight goes into two pixels' num (FMA,
    2) and den (1): 6."""
    n, h, w, c = x.shape
    radii = kb.size01_to_radius(params[:, 1]).tolist()
    distinct = sum(((2 * s + 1) ** 2 - 1) // 2 for s in radii) * h * w * c
    moved = 2 * x.numel() * 4 + params.numel() * 4
    return _bound(moved, 14 * distinct, distinct)


BOUNDS = {"bilateral": bilateral_bound, "median": median_bound,
          "fastnlm": fastnlm_bound}


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


def load_pipeline(dev, arch: str = SLICE2, use_proxy: bool = False,
                  bank=None) -> Pipeline:
    """A pipeline with the in-repo bank's weights and the init logits."""
    bank = load_network(str(BANK)) if bank is None else bank
    pipe = Pipeline(arch, use_proxy, device=dev)
    return pipe.load_state(convert.state_from_bank(bank, pipe))


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


# csrc/<name>.cu built with -D<macro> holds one kernel per C and radius
BODY_MACROS = {"median": "MEDIAN_BODY_KERNELS",
               "bilateral": "BILATERAL_BODY_KERNELS"}


def _start_bodies(name: str):
    """nvcc for csrc/<name>.cu with one kernel per C and radius, into a
    cubin beside the libraries."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cubin = _build.BUILD_DIR / f"{name}-bodies.cubin"
    flags = [f for f in _build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    cmd = [_build.nvcc(), *flags, "-cubin", f"-D{BODY_MACROS[name]}", "-o",
           str(cubin), str(_build.CSRC / f"{name}.cu")]
    return cubin, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True)


def _body_key(name: str, symbol: str):
    """(C, radius) of a mangled <name>_kernel<C, R> name, or None."""
    m = re.search(name + r"_kernelILi(\d)ELi(\d)EE", symbol)
    return (int(m[1]), int(m[2])) if m and m[2] != "0" else None


def _body_report(name: str, cubin: Path, proc, sass_op: str):
    """ptxas's {(C, radius): {"registers", "spill_bytes"}} of each body, and
    {(C, radius): {group: count}} of the SASS instructions that match
    `sass_op` (counted by its first group), or {} without cuobjdump.
    Raises on a failed build or a missing body."""
    output, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"{name} bodies: nvcc exited {proc.returncode}\n"
                           f"{output}")
    ptxas, current = {}, None
    for ln in output.splitlines():
        m = re.search(r"entry function '([^']+)'|Function properties for (\S+)",
                      ln)
        if m:
            current = _body_key(name, m[1] or m[2])
            continue
        if current is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if spill:
            ptxas.setdefault(current, {})["spill_bytes"] = (
                int(spill[1]) + int(spill[2]))
        regs = re.search(r"Used (\d+) registers", ln)
        if regs:
            ptxas.setdefault(current, {})["registers"] = int(regs[1])
    if sorted(ptxas) != [(c, r) for c in (1, 3) for r in range(1, 8)]:
        raise RuntimeError(f"{name} bodies: ptxas reported {sorted(ptxas)}")
    counts = {}
    cuobjdump = shutil.which("cuobjdump") or str(
        Path(_build.nvcc()).with_name("cuobjdump"))
    if Path(cuobjdump).is_file():
        sass = subprocess.run([cuobjdump, "-sass", str(cubin)],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        current = None
        for ln in sass.splitlines():
            m = re.search(r"Function : (\S+)", ln)
            if m:
                current = _body_key(name, m[1])
                if current is not None:
                    counts[current] = {}
                continue
            op = re.search(sass_op, ln)
            if current is not None and op:
                counts[current][op[1]] = counts[current].get(op[1], 0) + 1
    return ptxas, counts


def _median_bodies(cubin: Path, proc) -> list:
    """One line per median body: ptxas's registers and spills, and the
    integer min/max instructions in its SASS (two-input IMNMX or VIMNMX, and
    the three-input VIMNMX3 that ptxas fuses from a min of a min).  A network
    body's two-input equivalents, less those of the same C's radius-7
    bisection body (the staging's reflections), are its network's: the
    pruned count, or a few more.  Returns the faults: a spill, or a network
    left unpruned."""
    ptxas, minmax = _body_report("median", cubin, proc, r"\bV?IMNMX(3?)[.\s]")
    faults = []
    for (c, r), info in sorted(ptxas.items()):
        sass = "no cuobjdump"
        if (c, r) in minmax:
            two, three = minmax[c, r].get("", 0), minmax[c, r].get("3", 0)
            sass = f"{two}+{three}x3"
            if r in MEDIAN_NETWORK_MINMAX:
                network = two + 2 * three - minmax[c, 7].get("", 0)
                sass += f" network={network}"
                if network > MEDIAN_NETWORK_MINMAX[r] + 8:
                    faults.append(f"median C={c} r={r} keeps dead comparators")
        if info["spill_bytes"]:
            faults.append(f"median C={c} r={r} spills")
        line("phase 2 median body", c=c, radius=r,
             selection="network" if r in MEDIAN_NETWORK_MINMAX else "bisection",
             registers=info.get("registers"), spill_bytes=info["spill_bytes"],
             sass_int_minmax=repr(sass),
             pruned_network_minmax=MEDIAN_NETWORK_MINMAX.get(r))
    return faults


def _bilateral_bodies(cubin: Path, proc) -> list:
    """One line per bilateral body: ptxas's registers and spills, and the
    MUFU.EX2 in its SASS beside the design's BILATERAL_ROWS (2R+1) C (one
    column offset's taps).  Returns the faults: a spill, or another count
    of exps."""
    ptxas, mufu = _body_report("bilateral", cubin, proc, r"\bMUFU\.(EX2)\b")
    faults = []
    for (c, r), info in sorted(ptxas.items()):
        design = BILATERAL_ROWS * (2 * r + 1) * c
        ex2 = mufu.get((c, r), {}).get("EX2") if mufu else "no cuobjdump"
        if mufu and ex2 != design:
            faults.append(f"bilateral C={c} r={r}: {ex2} MUFU.EX2, not {design}")
        if info["spill_bytes"]:
            faults.append(f"bilateral C={c} r={r} spills")
        line("phase 2 bilateral body", c=c, radius=r,
             registers=info.get("registers"), spill_bytes=info["spill_bytes"],
             sass_mufu_ex2=ex2, design_mufu_ex2=design,
             exps_per_output_value=(2 * r + 1) ** 2)
    return faults


def phase_build() -> None:
    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    missing = set(KERNELS) - set(sources)
    if missing:
        raise FileNotFoundError(f"no source for kernels {sorted(missing)}")
    bodies = {name: _start_bodies(name) for name in BODY_MACROS}
    try:
        report = _build.build(sources)
        for name in sources:
            if name in report:
                secs, output = report[name]
                ptxas = [ln.strip() for ln in output.splitlines()
                         if "registers" in ln or "spill" in ln]
                line("phase 2 build", kernel=name, seconds=f"{secs:.2f}",
                     ptxas=repr(" | ".join(ptxas)))
                if re.search(r"[1-9]\d* bytes spill", output):
                    raise RuntimeError(f"{name}: ptxas reports spills")
            else:
                line("phase 2 build", kernel=name, seconds=0, cached=True)
            _build.load(name)
        faults = (_median_bodies(*bodies["median"])
                  + _bilateral_bodies(*bodies["bilateral"]))
        if faults:
            raise RuntimeError("kernel bodies: " + "; ".join(faults))
    finally:
        for _, proc in bodies.values():
            proc.kill()  # nothing once it has ended
            proc.wait()


def _kernel_cases():
    """(kernel, case, shape, params rows, block radius) of phase 3.  Inputs
    are uniform in [0, 1]; those of a "saturated" case are clamped from
    2 u - 0.5, so a quarter of the values are exactly 0 and a quarter 1;
    those of a "constant" case are all 0.37.  A bilateral case ending in
    "sigma01_<s>" sets both sigma01 to s: 0 gives the most peaked weights
    (sigma 1), 1 the flattest (sigma 100); the others take a distinct sigma
    pair per image."""
    r17 = list(range(1, 8))
    for kind in ("", "saturated_", "constant_"):
        yield ("bilateral", f"{kind}tiles_8x512x512x3_r1-7", (8, 512, 512, 3),
               r17 + [4], 4)
        yield ("bilateral", f"{kind}tiles_8x512x512x1_r1-7", (8, 512, 512, 1),
               r17 + [4], 4)
        yield ("bilateral", f"{kind}frame_2x520x776x3_r3,7", (2, 520, 776, 3),
               [3, 7], 4)
    for sigma in (0, 1):
        for kind in ("", "saturated_"):
            yield ("bilateral", f"{kind}tiles_7x512x512x3_r1-7_sigma01_{sigma}",
                   (7, 512, 512, 3), r17, 4)
    for r in r17:
        yield "median", f"tiles_4x512x512x3_r{r}", (4, 512, 512, 3), [r] * 4, 4
        yield "median", f"tiles_4x256x256x1_r{r}", (4, 256, 256, 1), [r] * 4, 4
    yield "median", "frame_2x520x776x3_r7", (2, 520, 776, 3), [7, 7], 4
    for r in (4, 7):
        yield ("median", f"saturated_tiles_4x512x512x3_r{r}", (4, 512, 512, 3),
               [r] * 4, 4)
        yield ("median", f"saturated_frame_2x520x776x3_r{r}", (2, 520, 776, 3),
               [r] * 2, 4)
    for b in r17:
        yield "fastnlm", f"tiles_7x512x512x3_b{b}_s1-7", (7, 512, 512, 3), r17, b
        yield "fastnlm", f"tiles_7x256x256x1_b{b}_s1-7", (7, 256, 256, 1), r17, b
    yield "fastnlm", "frame_2x520x776x3_b4_s3,7", (2, 520, 776, 3), [3, 7], 4
    # phase 7's training batch, 4 x 192 x 192: C = 3 as the sRGB ops take
    # it, and C = 1
    for c in (3, 1):
        shape = (4, 192, 192, c)
        for radii in ((1, 2, 3, 4), (4, 5, 6, 7)):
            yield ("bilateral", f"train_4x192x192x{c}_r{radii[0]}-{radii[-1]}",
                   shape, list(radii), 4)
        for r in r17:
            yield "median", f"train_4x192x192x{c}_r{r}", shape, [r] * 4, 4
        for b in r17:
            yield ("fastnlm", f"train_4x192x192x{c}_b{b}_s1,3,5,7", shape,
                   [1, 3, 5, 7], b)
    # phase 8's search batch, 4 x 48 x 48 x 3 (the sRGB slots' input): every
    # radius, and every fast-NLM block radius with every search radius
    shape = (4, 48, 48, 3)
    for radii in ((1, 2, 3, 4), (4, 5, 6, 7)):
        yield ("bilateral", f"search_4x48x48x3_r{radii[0]}-{radii[-1]}",
               shape, list(radii), 4)
        for b in r17:
            yield ("fastnlm", f"search_4x48x48x3_b{b}_s{radii[0]}-{radii[-1]}",
                   shape, list(radii), b)
    for r in r17:
        yield "median", f"search_4x48x48x3_r{r}", shape, [r] * 4, 4


def phase_kernels(dev) -> dict:
    """Worst max abs error of each kernel against its plain form."""
    gen = torch.Generator(device=dev).manual_seed(1)
    worst = {name: 0.0 for name in KERNELS}
    for name, case, shape, radii, block in _kernel_cases():
        mod, plain, _, tol, _ = KERNELS[name]
        x = torch.rand(shape, generator=gen, device=dev)
        if case.startswith("saturated"):
            x = torch.clamp(2.0 * x - 0.5, 0.0, 1.0)
        elif case.startswith("constant"):
            x = torch.full_like(x, 0.37)
        sigma = case.partition("sigma01_")[2]
        p = kernel_params(name, radii, dev, block,
                          float(sigma) if sigma else None)
        got = getattr(mod, name)(x, p)
        want = plain(x, p)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        line("phase 3 kernel vs plain", kernel=name, case=case,
             max_abs_err=f"{err:.3e}", tol=tol)
        if not err <= tol:  # also false for a NaN
            raise AssertionError(f"{name} {case}: {err} > {tol}")
        worst[name] = max(worst[name], err)
    return worst


def _plain_spec(spec):
    """The op with its native form on the plain form where it is a kernel
    op (a native tuning target follows it)."""
    if spec.name not in KERNELS:
        return spec
    plain = KERNELS[spec.name][1]
    return dataclasses.replace(spec,
                               apply=lambda x, p, w, plain=plain: plain(x, p))


def _with_plain_kernels(pipe):
    """The pipeline's steps with every kernel op on its plain form."""
    return [(name, _plain_spec(spec)) for name, spec in pipe.steps]


def phase_serving(dev, arch, pipe, frames) -> dict:
    """Serve the frames through one path with every count set to 0 just
    before and read just after; returns the counts."""
    serve = make_serve(pipe, dev)
    n_tiles = (len(tile_positions(FRAME[0], PATCH, STRIDE))
               * len(tile_positions(FRAME[1], PATCH, STRIDE)))
    chunks = math.ceil(n_tiles / CHUNK)

    _zero_counts()
    y = serve(frames)
    torch.cuda.synchronize()
    launches = _counts()

    if tuple(y.shape) != (frames.shape[0], *FRAME, 3):
        raise AssertionError(f"output shape {tuple(y.shape)}")
    if not bool(torch.isfinite(y).all()):
        raise AssertionError("non-finite output")
    lo, hi = float(y.min()), float(y.max())
    if lo < 0.0 or hi > 1.0:
        raise AssertionError(f"output outside [0, 1]: {lo}..{hi}")
    expected = {name: chunks if name in PATHS[arch] else 0 for name in KERNELS}
    if launches != expected:
        raise AssertionError(f"{arch}: launches {launches} != {expected}")
    line("phase 4 serving", arch=arch, frames=tuple(frames.shape),
         out=tuple(y.shape), tiles_per_frame=n_tiles, chunks=chunks,
         launches=json.dumps(launches).replace(" ", ""),
         range=f"{lo:.4f}..{hi:.4f}")

    # the path's own output, whose kernel batches are (16, 512, 512, 3) and
    # a last (12, 512, 512, 3), against the plain forms on the same frames
    kernel_steps, pipe.steps = pipe.steps, _with_plain_kernels(pipe)
    try:
        y_plain = serve(frames)
    finally:
        pipe.steps = kernel_steps
    torch.cuda.synchronize()
    diff = float((y - y_plain).abs().max())
    line("phase 4 kernels vs plain end to end", arch=arch,
         max_abs_diff=f"{diff:.3e}", tol=E2E_TOL,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32)
    if not diff <= E2E_TOL:
        raise AssertionError(f"{arch} kernels vs plain: {diff} > {E2E_TOL}")
    return launches


def _zoo_arch(domain: str, idx: int) -> str:
    return {"bayer": f"Bayer_{idx:02d}_Demosaic_01_sRGB_10",
            "demosaic": f"Bayer_02_Demosaic_{idx:02d}_sRGB_10",
            "srgb": f"Bayer_02_Demosaic_01_sRGB_{idx:02d}"}[domain]


def phase_zoo(dev, bank) -> None:
    """Every op, native and proxy, on the card against the CPU."""
    x = torch.rand((2, 64, 96, 1), generator=torch.Generator().manual_seed(3))
    worst, runs = 0.0, 0
    for domain in ("bayer", "demosaic", "srgb"):
        for idx, spec in enumerate(pool(domain), start=1):
            modes = (False, True) if spec.proxy_apply is not None else (False,)
            for use_proxy in modes:
                arch = _zoo_arch(domain, idx)
                with torch.inference_mode():
                    got = load_pipeline(dev, arch, use_proxy, bank)(x.to(dev))
                    want = load_pipeline("cpu", arch, use_proxy, bank)(x)
                diff = float((got.cpu() - want).abs().max())
                if not diff <= ZOO_TOL:
                    raise AssertionError(
                        f"{arch} use_proxy={use_proxy}: card vs CPU {diff}")
                worst, runs = max(worst, diff), runs + 1
    line("phase 5 zoo", pipelines=runs, input=tuple(x.shape),
         max_abs_diff_card_vs_cpu=f"{worst:.3e}", tol=ZOO_TOL)


def phase_times(dev, pipes, frames) -> dict:
    """Each path's time at both storages; each kernel's time at the tile
    batch of the serving path's chunk size, every radius 4."""
    n = frames.shape[0]
    mp = n * FRAME[0] * FRAME[1] / 1e6
    for arch, pipe in pipes.items():
        serve = make_serve(pipe, dev)
        outs = {}
        for storage in ("f32", "bf16"):
            with precision.cnn_storage(storage):
                ms = event_ms(lambda: serve(frames), reps=2)
                outs[storage] = serve(frames[:1])
            line("phase 6 serving time", arch=arch, storage=storage,
                 ms_per_frame=f"{ms / n:.3f}",
                 mp_per_s=f"{mp / (ms / 1e3):.3f}",
                 cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
        diff = float((outs["bf16"] - outs["f32"]).abs().max())
        line("phase 6 bf16 vs f32 storage", arch=arch,
             frame=tuple(outs["f32"].shape), max_abs_diff=f"{diff:.3e}",
             tol=BF16_TOL)
        if not diff <= BF16_TOL:  # also false for a NaN
            raise AssertionError(f"bf16 vs f32 storage: {diff} > {BF16_TOL}")

    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.rand((8, PATCH, PATCH, 3), generator=gen, device=dev)
    for name in ("median", "bilateral"):
        mod = KERNELS[name][0]
        for r in range(1, 8):
            p = kernel_params(name, [r] * 8, dev)
            ms = event_ms(lambda: getattr(mod, name)(x, p), reps=20)
            bound, bound_by = BOUNDS[name](x, p)
            selection = {} if name != "median" else {"selection": (
                "network" if r in MEDIAN_NETWORK_MINMAX else "bisection")}
            line(f"phase 6 {name} time by radius", shape=tuple(x.shape),
                 radius=r, **selection, ms=f"{ms:.5f}",
                 bound_ms=f"{bound:.5f}", bound_by=bound_by)
    times = {}
    for name, (mod, plain, *_) in KERNELS.items():
        p = kernel_params(name, [4] * 8, dev)
        if name == "fastnlm":
            p[:, 2] = 0.5   # the init logit's decay, h = 50.5
        ms = event_ms(lambda: getattr(mod, name)(x, p), reps=20)
        plain_ms = event_ms(lambda: plain(x, p), reps=3)
        bound, bound_by = BOUNDS[name](x, p)
        line("phase 6 kernel time", kernel=name, shape=tuple(x.shape),
             radius=4, ms=f"{ms:.5f}", plain_ms=f"{plain_ms:.5f}",
             bound_ms=f"{bound:.5f}", bound_by=bound_by, library_ms=None)
        times[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                       "bound_by": bound_by}
    return times


def make_training_batch(dev, n: int, size: int) -> dict:
    """n pairs of size x size crops, made on the card from seed 0: a smooth
    BGR target, and as input its RGGB mosaic at half the light with noise,
    as a short exposure of SID's gives."""
    gen = torch.Generator(device=dev).manual_seed(0)
    coarse = torch.rand((n, 3, size // 16, size // 16), generator=gen,
                        device=dev)
    gt = F.interpolate(coarse, size=(size, size), mode="bilinear",
                       align_corners=False).permute(0, 2, 3, 1).contiguous()
    mosaic = torch.empty((n, size, size, 1), device=dev)
    mosaic[:, 0::2, 0::2, 0] = gt[:, 0::2, 0::2, 2]   # R
    mosaic[:, 0::2, 1::2, 0] = gt[:, 0::2, 1::2, 1]   # G
    mosaic[:, 1::2, 0::2, 0] = gt[:, 1::2, 0::2, 1]   # G
    mosaic[:, 1::2, 1::2, 0] = gt[:, 1::2, 1::2, 0]   # B
    noise = torch.randn(mosaic.shape, generator=gen, device=dev)
    return {"noisy": torch.clamp(0.5 * mosaic + 0.02 * noise, 0.0, 1.0),
            "gt": gt}


def sid_isp_options():
    """configs/SID_isp.yaml read through the port's config.parse, its
    paths under a temporary root: (architecture, use_proxy, train options,
    batch size, crop size)."""
    with tempfile.TemporaryDirectory() as root:
        opt = config.parse(str(SID_ISP), root=root)
    data = opt["datasets"]["train"]
    return (opt["network_G"]["architecture"],
            config.network_uses_proxy(opt["network_G"]), opt["train"],
            data["batch_size"], data["data_size"])


def make_trainer(dev, arch, use_proxy, bank, train_opt,
                 plain: bool = False) -> IspTrainer:
    """An IspTrainer on a pipeline with the bank's weights and the init
    logits, its kernel ops on their plain forms if `plain`."""
    pipe = load_pipeline(dev, arch, use_proxy, bank)
    if plain:
        pipe.steps = _with_plain_kernels(pipe)
    return IspTrainer(pipe, train_opt)


def _train_run(trainer: IspTrainer, batch: dict) -> dict:
    """TRAIN_STEPS steps, with every count set to 0 just before the steps
    and read just after."""
    dev = trainer.pipeline.device
    start_logits = convert.state_to_jax(trainer.pipeline)["logits"]
    before = trainer.eval_loss(batch)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_counts()
    losses = []
    for step in range(TRAIN_STEPS):
        if step == TRAIN_WARMUP:
            start.record()
        losses.append(trainer.train_step(batch)["loss"])
    end.record()
    torch.cuda.synchronize()
    launches = _counts()
    return {"losses": losses, "before": before,
            "after": trainer.eval_loss(batch), "launches": launches,
            "ms": start.elapsed_time(end) / (TRAIN_STEPS - TRAIN_WARMUP),
            "peak_bytes": torch.cuda.max_memory_allocated(dev),
            "start_logits": start_logits,
            "logits": convert.state_to_jax(trainer.pipeline)["logits"]}


def phase_training(dev, bank) -> dict:
    """Step-2 training of SID_isp's pipeline and of both kernel paths, with
    the kernels and with the plain forms; returns the kernels' forward
    launches over the kernel runs."""
    flagship, use_proxy, train_opt, n, size = sid_isp_options()
    batch = make_training_batch(dev, n, size)
    train_launches = {name: 0 for name in KERNELS}
    for arch, kernels in {flagship: (), **PATHS}.items():
        runs = {plain: _train_run(make_trainer(dev, arch, use_proxy, bank,
                                               train_opt, plain), batch)
                for plain in (False, True)}
        for plain, run in runs.items():
            mode = "plain" if plain else "kernels"
            if not all(math.isfinite(v) for v in run["losses"]):
                raise AssertionError(f"{arch} {mode}: losses {run['losses']}")
            if not run["after"] < run["before"]:
                raise AssertionError(
                    f"{arch} {mode}: eval loss {run['before']} -> "
                    f"{run['after']} did not fall")
            expected = {name: 0 if plain or name not in kernels
                        else TRAIN_STEPS for name in KERNELS}
            if run["launches"] != expected:
                raise AssertionError(f"{arch} {mode}: launches "
                                     f"{run['launches']} != {expected}")
            line("phase 7 training", arch=arch, mode=mode,
                 batch=tuple(batch["noisy"].shape), steps=TRAIN_STEPS,
                 ms_per_step=f"{run['ms']:.3f}",
                 peak_mib=f"{run['peak_bytes'] / 2**20:.1f}",
                 eval_loss=f"{run['before']:.6f}->{run['after']:.6f}",
                 launches=json.dumps(run["launches"]).replace(" ", ""))
        kern, ref = runs[False], runs[True]
        diff = max(float(abs(kern["logits"][k] - ref["logits"][k]).max())
                   for k in ref["logits"])
        moved = max(float(abs(v - kern["start_logits"][k]).max())
                    for k, v in kern["logits"].items())
        loss_diff = max(abs(a - b) / abs(b)
                        for a, b in zip(kern["losses"], ref["losses"]))
        line("phase 7 kernels vs plain logits", arch=arch,
             max_abs_diff=f"{diff:.3e}", tol=TRAIN_LOGIT_TOL,
             max_logit_move=f"{moved:.3e}",
             max_loss_rel_diff=f"{loss_diff:.3e}", loss_rtol=TRAIN_LOSS_RTOL)
        if not diff <= TRAIN_LOGIT_TOL:
            raise AssertionError(f"{arch}: logits {diff} > {TRAIN_LOGIT_TOL}")
        if not loss_diff <= TRAIN_LOSS_RTOL:
            raise AssertionError(
                f"{arch}: losses {kern['losses']} vs {ref['losses']}")
        for name in KERNELS:
            train_launches[name] += kern["launches"][name]
    return train_launches


def phase_gradients(dev) -> None:
    """Each kernel's gradient through its autograd Function against the
    plain form's autograd, for x and params, of sum(k(x, p) g): at the
    training batch, where the backward is direct, bit for bit; at a
    1024-row frame, radius 7, where it goes by strips, within STRIP_TOL."""
    gen = torch.Generator(device=dev).manual_seed(4)
    for name, (mod, plain, *_) in KERNELS.items():
        for case, shape, radii, block in GRAD_CASES:
            x = torch.rand(shape, generator=gen, device=dev)
            g = torch.randn(shape, generator=gen, device=dev)
            p = kernel_params(name, radii, dev, block)
            if name == "fastnlm":   # h = 90.1: noise patches keep weights
                p[:, 2] = 0.9       # of about exp(-255^2 / 6 / h^2) = 0.26
            grads = []
            for fn in (getattr(mod, name), plain):
                xs, ps = x.clone().requires_grad_(), p.clone().requires_grad_()
                grads.append(torch.autograd.grad(fn(xs, ps), (xs, ps), g,
                                                 allow_unused=True))
            torch.cuda.synchronize()
            (gx, gp), (wx, wp) = grads
            if (gp is None) != (wp is None):
                raise AssertionError(f"{name} {case}: params gradient "
                                     f"{gp is None} vs {wp is None}")
            dx = float((gx - wx).abs().max())
            dp = 0.0 if wp is None else float((gp - wp).abs().max())
            scale = 0.0 if wp is None else float(wp.abs().max())
            line("phase 7 gradient vs plain", kernel=name, case=case,
                 shape=shape, radius=max(radii),
                 max_abs_diff_x=f"{dx:.3e}", max_abs_diff_params=f"{dp:.3e}",
                 params_grad_max=f"{scale:.3e}")
            if shape[1] <= _vjp.DIRECT_ROWS:
                same = torch.equal(gx, wx) and (wp is None
                                                or torch.equal(gp, wp))
                if not same:
                    raise AssertionError(f"{name} {case}: not bit-identical")
            elif not (dx <= STRIP_TOL and dp <= STRIP_TOL * max(1.0, scale)):
                raise AssertionError(f"{name} strip: {dx}, {dp} > {STRIP_TOL}")


def phase_latency(dev) -> dict:
    """The per-op latency table (ms/MP) at LATENCY_SIZE^2, batch 1, native
    and with proxies; the native one is installed into the registry."""
    tables = {}
    for use_proxies in (False, True):
        table = latency.calibrate(size=LATENCY_SIZE, batch=1,
                                  use_proxies=use_proxies, device=dev)
        bad = {k: v for k, v in table.items()
               if not (math.isfinite(v) and v > 0)}
        if bad:
            raise AssertionError(f"latency table: {bad}")
        mode = "proxy" if use_proxies else "native"
        for name, ms in table.items():
            line("phase 8 latency", op=name, mode=mode,
                 size=f"{LATENCY_SIZE}x{LATENCY_SIZE}",
                 ms_per_mp=f"{ms:.6f}")
        tables[mode] = table
    latency.install(tables["native"])
    return tables


def make_planted_batch(dev, n: int, size: int, gen) -> dict:
    """n planted crops: a smooth BGR scene under the camera's cast, its
    clean RGGB mosaic, the target from the clean mosaic through Malvar
    demosaic, wb_manual and gamma at the planted params, and as input the
    mosaic with shot and read noise (configs/planted_search.yaml)."""
    coarse = torch.rand((n, 3, size // 8, size // 8), generator=gen,
                        device=dev)
    scene = F.interpolate(coarse, size=(size, size), mode="bilinear",
                          align_corners=False).permute(0, 2, 3, 1)
    cast = torch.tensor(PLANTED_CAST, device=dev)
    lit = torch.clamp(scene * cast, 0.0, 1.0)
    clean = torch.empty((n, size, size, 1), device=dev)
    clean[:, 0::2, 0::2, 0] = lit[:, 0::2, 0::2, 2]   # R
    clean[:, 0::2, 1::2, 0] = lit[:, 0::2, 1::2, 1]   # G
    clean[:, 1::2, 0::2, 0] = lit[:, 1::2, 0::2, 1]   # G
    clean[:, 1::2, 1::2, 0] = lit[:, 1::2, 1::2, 0]   # B
    wb = torch.tensor([PLANTED_WB01], device=dev).expand(n, 3)
    g = torch.tensor([[PLANTED_GAMMA01]], device=dev).expand(n, 1)
    gt = color.gamma(color.wb_manual(demosaic.demosaic_malvar(clean), wb), g)
    sigma = torch.sqrt(PLANTED_SHOT ** 2 * clean + PLANTED_READ ** 2)
    noise = torch.randn(clean.shape, generator=gen, device=dev)
    return {"noisy": torch.clamp(clean + sigma * noise, 0.0, 1.0),
            "gt": torch.clamp(gt, 0.0, 1.0)}


def search_options(path: Path):
    """A search option file through the port's config.parse, its paths
    under a temporary root."""
    with tempfile.TemporaryDirectory() as root:
        return config.parse(str(path), root=root)


def make_search_trainer(dev, bank, opt, *, plain=False, remat=None,
                        order=None, ft=False):
    """A DartsTrainer (DartsFtTrainer with `ft`) on the supernet the options
    describe, omega from the bank, its kernel ops on their plain forms if
    `plain`."""
    kw = config.supernet_kwargs(opt)
    if remat is not None:
        kw["remat"] = remat
    net = SuperNet(**kw, device=dev)
    if plain:
        net.slots = [(slot, [_plain_spec(s) for s in ops])
                     for slot, ops in net.slots]
    train_opt = dict(opt["train"])
    if order is not None:
        train_opt["darts_order"] = order
    trainer = (DartsFtTrainer(net, train_opt, opt["proxy_ft_params"] or {})
               if ft else DartsTrainer(net, train_opt))
    installed = trainer.load_pretrained(bank)
    missing = sorted(set(trainer.variables["omega"]) - set(installed))
    if missing:
        raise AssertionError(f"the bank lacks {missing}")
    return trainer


def _search_run(trainer, train, val, steps: int = SEARCH_STEPS,
                record: bool = False) -> dict:
    """`steps` search steps, with every count set to 0 just before the
    steps and read just after; steps after SEARCH_WARMUP timed.  With
    `record`, each step's intermediates go into the ft trainer's memory, as
    the JAX package's run_training records them."""
    dev = trainer.net.device
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_counts()
    logs = []
    for step in range(steps):
        if step == SEARCH_WARMUP:
            start.record()
        logs.append(trainer.search_step(train, val))
        if record:
            trainer.record_intermediates()
    end.record()
    torch.cuda.synchronize()
    return {"logs": logs, "launches": _counts(),
            "ms": start.elapsed_time(end) / (steps - SEARCH_WARMUP),
            "peak_bytes": torch.cuda.max_memory_allocated(dev)}


def _search_line(what: str, run: dict, **fields) -> None:
    losses = [lg["loss"] for lg in run["logs"]]
    line("phase 8 search", run=what, **fields,
         ms_per_step=f"{run['ms']:.3f}",
         peak_mib=f"{run['peak_bytes'] / 2**20:.1f}",
         loss=f"{losses[0]:.6f}->{losses[-1]:.6f}",
         val_loss=f"{run['logs'][0]['val_loss']:.6f}->"
                  f"{run['logs'][-1]['val_loss']:.6f}",
         launches=json.dumps(run["launches"]).replace(" ", ""))
    if not all(math.isfinite(v) for lg in run["logs"] for v in lg.values()):
        raise AssertionError(f"{what}: logs {run['logs']}")


def _max_diff(a: dict, b: dict) -> float:
    if isinstance(a, dict):
        return max((_max_diff(a[k], b[k]) for k in a), default=0.0)
    return float((a - b).abs().max())


def phase_search(dev, bank) -> dict:
    """Step-1 search at SID_search's geometry; returns the kernels' launches
    in the second-order run with the kernels and remat on (the default)."""
    opt = search_options(SID_SEARCH)
    data = opt["datasets"]["train"]
    n, size = data["batch_size"], data["data_size"]
    gen = torch.Generator(device=dev).manual_seed(0)
    train = make_planted_batch(dev, n, size, gen)
    val = make_planted_batch(dev, n, size, gen)

    runs = {}
    for what, kw in (("order2_kernels", {}), ("order2_plain", {"plain": True}),
                     ("order2_kernels_remat_off", {"remat": False})):
        trainer = make_search_trainer(dev, bank, opt, **kw)
        if what == "order2_kernels":
            _, aux = trainer.net(trainer.variables, train["noisy"],
                                 return_aux=True)
            line("phase 8 supernet", slots=len(trainer.net.slots),
                 ops_per_srgb_slot=len(trainer.net.slots[-1][1]),
                 remat=trainer.net.remat, batch=tuple(train["noisy"].shape),
                 expected_latency_ms_per_mp=f"{float(aux['latency']):.6f}")
        run = _search_run(trainer, train, val)
        run["trainer"] = trainer
        runs[what] = run
        _search_line(what, run, remat=trainer.net.remat)
        expected_zero = what == "order2_plain"
        for name, count in run["launches"].items():
            if (count == 0) != expected_zero:
                raise AssertionError(f"{what}: launches {run['launches']}")

    kern, ref = runs["order2_kernels"], runs["order2_plain"]
    loss_diff = max(abs(a[k] - b[k]) / abs(b[k])
                    for a, b in zip(kern["logs"], ref["logs"])
                    for k in ("loss", "val_loss"))
    kv, rv = kern["trainer"].variables, ref["trainer"].variables
    alpha_diff = _max_diff(kv["alphas"], rv["alphas"])
    theta_diff = _max_diff(kv["theta"], rv["theta"])
    start = make_search_trainer(dev, bank, opt).variables
    line("phase 8 kernels vs plain", steps=SEARCH_STEPS,
         max_loss_rel_diff=f"{loss_diff:.3e}", loss_rtol=SEARCH_LOSS_RTOL,
         max_alpha_diff=f"{alpha_diff:.3e}", alpha_tol=SEARCH_ALPHA_TOL,
         max_theta_diff=f"{theta_diff:.3e}", theta_tol=SEARCH_THETA_TOL,
         max_alpha_move=f"{_max_diff(kv['alphas'], start['alphas']):.3e}",
         max_theta_move=f"{_max_diff(kv['theta'], start['theta']):.3e}")
    if not (loss_diff <= SEARCH_LOSS_RTOL and alpha_diff <= SEARCH_ALPHA_TOL
            and theta_diff <= SEARCH_THETA_TOL):
        raise AssertionError("search: kernels vs plain forms part")

    arch = kern["trainer"].architecture()
    pipe = load_pipeline(dev, arch, bank=bank)
    with torch.inference_mode():
        y = pipe(val["noisy"])
    if tuple(y.shape) != (n, size, size, 3) or not bool(
            torch.isfinite(y).all()):
        raise AssertionError(f"{arch}: output {tuple(y.shape)}")
    line("phase 8 architecture", arch=arch,
         pruned=kern["trainer"].pruned_paths(val["noisy"]).tolist(),
         out=tuple(y.shape), range=f"{float(y.min()):.4f}..{float(y.max()):.4f}")

    planted = search_options(PLANTED_SEARCH)
    trainer = make_search_trainer(dev, bank, planted, order=1)
    run = _search_run(trainer, train, val)
    _search_line("order1_planted_rates", run, remat=trainer.net.remat)
    if not run["logs"][-1]["loss"] < run["logs"][0]["loss"]:
        raise AssertionError(f"order 1: loss {run['logs']} did not fall")

    planted_ft = search_options(PLANTED_SEARCH_FT)
    trainer = make_search_trainer(dev, bank, planted_ft, ft=True)
    run = _search_run(trainer, train, val, FT_SEARCH_STEPS, record=True)
    _search_line("ft_planted", run, remat=trainer.net.remat,
                 use_proxies=trainer.net.use_proxies)
    _zero_counts()
    ft_logs = trainer.finetune_proxies()
    torch.cuda.synchronize()
    ft_launches = _counts()
    line("phase 8 finetune_proxies", memory=len(trainer.ft_data),
         ft_steps=trainer.ft_steps,
         losses=json.dumps({k: round(v, 8) for k, v in ft_logs.items()})
         .replace(" ", ""),
         target_launches=json.dumps(ft_launches).replace(" ", ""))
    if sorted(ft_logs) != sorted(f"ft_{s.name}" for s in trainer.ft_ops) \
            or not all(math.isfinite(v) for v in ft_logs.values()):
        raise AssertionError(f"finetune_proxies: {ft_logs}")
    expected = {name: trainer.ft_steps for name in KERNELS}
    if ft_launches != expected:
        raise AssertionError(f"tuning targets: launches {ft_launches} "
                             f"!= {expected}")
    return kern["launches"]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", torch.cuda.current_device())
    tf32_off()

    phase_environment(dev)
    phase_build()
    max_err = phase_kernels(dev)

    bank = load_network(str(BANK))
    frames = make_frames(dev)
    pipes = {arch: load_pipeline(dev, arch, bank=bank) for arch in PATHS}
    launches = {}
    for arch, pipe in pipes.items():
        counts = phase_serving(dev, arch, pipe, frames)
        launches.update({name: counts[name] for name in PATHS[arch]})
    phase_zoo(dev, bank)
    times = phase_times(dev, pipes, frames)
    del frames, pipes
    train_launches = phase_training(dev, bank)
    phase_gradients(dev)
    phase_latency(dev)
    search_launches = phase_search(dev, bank)

    kernels = [{
        "name": name, "route": "cuda",
        "source": f"reconfigisp_tpu_torch/csrc/{name}.cu",
        "replaces": replaces, "launches": launches[name],
        "train_launches": train_launches[name],
        "search_launches": search_launches[name],
        "max_abs_err": max_err[name], **times[name], "library_ms": None,
    } for name, (*_, replaces) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

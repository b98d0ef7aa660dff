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
     4x192x192 training batch, phase 8's 4x48x48x3 search batch and phase
     10's 4x256x256x3 and 2x512x512x3; the median and the bilateral also on
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
     custom op's autograd against the plain form's: bit for bit where the
     backward is direct (the training batch and the search batch
     4x48x48x3), within STRIP_TOL where it goes by strips; fast NLM's
     and the bilateral's backward kernels within BACKWARD_KERNEL_RTOL of
     the largest value;
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
     finetune_proxies, whose targets launch the kernels;
  9. the entry points a user runs, each CLI in a subprocess whose launches
     are counted from 0 (run_cli), TF32 off: (a) proxy pretraining of the
     bilateral, median, fast-NLM and bm3d proxies at the JAX defaults
     (batch 8 of 48x48), with the kernels and with the plain forms as
     targets; then on 4 SID-size packed records written here from seed 0:
     (b) python -m reconfigisp_tpu_torch.train on configs/SID_isp.yaml with
     slice 2's architecture, then resumed; (c) the same CLI on
     configs/SID_search.yaml, then resumed, and on
     configs/planted_search_ft.yaml from (a)'s proxies; (d) python -m
     reconfigisp_tpu_torch.test at configs/SID_test.yaml's tiling on two
     full frames with (b)'s network, f32 and bf16, the first frame held
     against make_serving_fn.  PRETRAIN_STEPS and the step counts below it
     list the cuts;
 10. the detection path under the frozen 80-class YOLOv3, its weights the
     port's seeded init written as a darknet file, on synthetic_yolo
     frames: the forward on the card against the CPU; (a)
     configs/yolo_search.yaml (batch 4 of 256x256) through the train CLI,
     then resumed, and in process with the kernels and with the plain
     forms (losses, alphas and theta held within YOLO_*_TOL), the
     detector's share of a step, the argmax architecture served; (b)
     configs/yolo_isp.yaml (batch 2 of 512x512), its flagship and slice 2
     with the kernels and the plain forms; (c) configs/yolo_test.yaml's
     whole 1024x1024 frames through the test CLI with (b)'s network, map=
     printed, the first frame's detections held against an in-process
     decode and NMS.  YOLO_FRAMES and the step counts below it list the
     cuts;
 11. the deployment path, from a camera file to a served frame: (a) build
     native/rawproc.cpp with g++ and hold its four functions against their
     numpy forms on a 2848x4256 uint16 frame from seed 0; (b) write two
     SID-size 14-bit DNG pairs from seed 0, read them back bit-exact, and
     ingest them with process_raw_pairs into packed records of 512x512
     patches and of whole frames, MB/s printed; (c) export slice 2 with
     the tiled engine at 1x2848x4256x1 (patch 512, stride 480, chunk 8),
     f32 and bf16 storage, save it, then load and serve the ingested frame
     in a fresh process that imports deploy alone, its launches counted
     from 0, held against make_serving_fn within ARTIFACT_TOL with the
     same launches, ms a frame of both; (d) the flagship exported
     whole-frame with a symbolic batch, served at batch 1 and 2, and slice
     1 exported whole-frame and served in this process, its bilateral
     launches counted;
 12. one dispatch per search step: the search trainers of phases 8-10 run
     each step as a replay of one captured CUDA graph (their launches
     counted through the replays); here each captured run is held against
     eager steps (make_darts_step) from one start on the same batches:
     (a) SID_search order 2, 6 steps eager, captured at K = 1 and at K = 4
     steps a dispatch, ms a step, the capture's seconds and pool, and one
     captured step under torch.profiler (busy share, kernels a replay);
     (b) order 1 at planted_search.yaml's rates; (c) DartsFtTrainer at
     planted_search_ft.yaml, K = 1 and K = 2, 2 steps (the replay memories
     equal eager's), finetune_proxies, 2 steps against eager steps from
     the same tuned state (the replays read the tuned proxies); (d)
     darts_yolo at yolo_search.yaml's geometry, 3 steps;
 13. data parallelism over a process group (parallel/mesh.py, dp.py),
     each run held against the serial one on the same global batches, the
     kernels' launches counted on every rank: (a) dryrun_multichip over two
     gloo ranks sharing the card (parallel/launch.spawn); over two gloo
     ranks in one spawn, (b) configs/SID_search.yaml as written (dist:
     true, a (2, 1) mesh from dist_mesh), 3 eager order-2 steps against
     the serial trainer's captured steps, 15 launches a kernel a step on
     each rank, (d) configs/SID_isp.yaml with slice 2, 3 IspTrainer steps,
     and configs/yolo_search.yaml under phase 10's detector, 2 steps,
     and (f) the flagship exported whole-frame with data_parallel=2 and
     served by both ranks against make_serving_fn; (c) one NCCL rank,
     make_mesh(1) passed explicitly so that the all-reduces run inside the
     captured graph, at K = 1 and 2 against the trainer without a mesh;
     (e) python -m torch.distributed.run --nproc-per-node 2 over the train
     CLI on phase 9's records against 9c's serial run, the checkpoint
     saved by rank 0 alone;
 14. the mesh's space axis on whole frames (parallel/space.py: each rank
     runs a window of its frames' rows with the network's row radius on
     each side, the global ops reduced over the space group), in phase
     13's spawn of two gloo ranks over a (1, 2) mesh, each run held
     against the unsharded run on the same inputs, launches counted on
     each rank: (a) two 2848x4256 frames from seed 0 served by
     make_data_parallel_apply through slice 1, slice 2 and a pipeline of
     every global op (SPACE_GLOBAL), against the whole-frame
     make_serving_fn; (b) slice 2 exported with data_parallel=1,
     space_parallel=2 at 1x2848x4256x1, loaded and served by both ranks;
     (c) configs/SID_search.yaml as written, 3 order-2 steps against 13b's
     serial run, and configs/SID_isp.yaml's slice 2, 3 steps against
     13d's; (d) dryrun_multichip over four gloo ranks on the card, a
     (2, 2) mesh;
 15. the method's accuracy tools and the real-scale rehearsal
     (reconfigisp_tpu_torch/tools/), each a subprocess through run_cli
     with its launches counted: (a) tools/planted_demo.py, seeds 0 and 1
     (PLANTED_SEEDS), at PLANTED_SMOKE's budgets (module pretraining, then
     for each seed the native, proxy and darts_ft searches of
     configs/planted_search*.yaml with one tuning round, step-2 training
     of the searched architecture and its ablations through
     configs/planted_isp.yaml, held-out PSNR), then
     tools/ft_divergence.py: for each seed every decoded architecture
     builds, every loss and the margin are finite, each step-2 training
     lowers the loss on its first batch (or leaves a pipeline whose
     parameters get no gradient as it was); the cross-seed aggregates
     count both seeds; and seed 0's searched architecture trained here
     scores the same held-out PSNR on the card and on the CPU within
     EVAL_PSNR_TOL_DB; (b)
     tools/rehearse_real_scale.py's SID leg (14-bit DNGs of 1424x2128
     ingested, configs/SID_search.yaml, SID_isp.yaml, SID_test.yaml's
     tiled test) and S7 leg (10-bit GRBG frames of 3024x4032 cropped to
     RGGB, S7ISP_search_ft.yaml, S7ISP_isp.yaml, S7ISP_test.yaml) at
     REHEARSAL_ITERS search and REHEARSAL_LEARN learning steps and one test
     frame: the steps as asked, finite losses and test PSNR, the kernels'
     launches exact;
 16. the rehearsal's OnePlus/YOLO leg (tools/rehearse_real_scale.py
     --legs yolo), a subprocess beside phase 15's, cv2 unimportable: two
     3000x4000 10-bit mosaics written as 16-bit PNGs with labelme JSONs,
     an 80-class YOLOv3 darknet file pretrained YOLO_LEG's criterion steps
     on the letterboxed scenes and read back for its self-check,
     configs/yolo_search.yaml, yolo_isp.yaml and yolo_test.yaml's 1024
     test on the OnePlus loader (PNG reads and area resizes without cv2):
     the first PNG read back equal to its mosaic, the steps as asked,
     finite losses, `map=` printed, the kernels' launches exact.
Then one JSON line with the kernels and, last, the device line.  Every check
raises on failure; without CUDA the script exits 1 before printing a result.
The tools/profile_torch_*.py and tools/time_torch_padding.py scripts import
their set-up from here.
"""

from __future__ import annotations

import ast
import contextlib
import copy
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
import yaml

from reconfigisp_tpu_torch import Pipeline, config, convert, pool, precision
from reconfigisp_tpu_torch.data import SyntheticRawDataset, create_dataset, dng
from reconfigisp_tpu_torch.data.backends import PackedPairWriter
from reconfigisp_tpu_torch.data.preprocessing import process_raw_pairs
from reconfigisp_tpu_torch.deploy import (
    export_pipeline, make_serving_fn, save_artifact)
from reconfigisp_tpu_torch.deploy import load_pipeline as load_artifact
from reconfigisp_tpu_torch.native import rawproc
from reconfigisp_tpu_torch.ops.kernels import _build
from reconfigisp_tpu_torch.ops.kernels import bilateral as kb
from reconfigisp_tpu_torch.ops.kernels import fastnlm as kf
from reconfigisp_tpu_torch.ops.kernels import median as km
from reconfigisp_tpu_torch.parallel import launch
from reconfigisp_tpu_torch.parallel import mesh as meshlib
from reconfigisp_tpu_torch.parallel import space
from reconfigisp_tpu_torch.parallel.dp import make_data_parallel_apply
from reconfigisp_tpu_torch.parallel.dryrun import dryrun_multichip
from reconfigisp_tpu_torch.parallel.tiling import feather_mask, tile_positions
from reconfigisp_tpu_torch.ops import color, demosaic, denoise
from reconfigisp_tpu_torch.ops.kernels import _vjp
from reconfigisp_tpu_torch.search import DartsFtTrainer, DartsTrainer, IspTrainer
from reconfigisp_tpu_torch.search.darts import _leaves
from reconfigisp_tpu_torch.search.proxy_pretrain import pretrain_modules
from reconfigisp_tpu_torch.search.trainer import (
    build_yolo_evaluator, dist_mesh, make_yolo_criterion)
from reconfigisp_tpu_torch.supernet import SuperNet
from reconfigisp_tpu_torch.tools import planted_demo
from reconfigisp_tpu_torch.tools import rehearse_real_scale as rehearsal
from reconfigisp_tpu_torch.utils import latency, png
from reconfigisp_tpu_torch.utils.checkpoint import load_network, save_network
from reconfigisp_tpu_torch.yolo import cfg as ycfg
from reconfigisp_tpu_torch.yolo import train as ytrain
from reconfigisp_tpu_torch.yolo.net import (
    init_yolo, load_darknet_weights, save_darknet_weights)

ROOT = Path(__file__).resolve().parent
BANK = ROOT / "experiments" / "proxies" / "default.ckpt"
SID_ISP = ROOT / "configs" / "SID_isp.yaml"
SID_SEARCH = ROOT / "configs" / "SID_search.yaml"
PLANTED_SEARCH = ROOT / "configs" / "planted_search.yaml"
PLANTED_SEARCH_FT = ROOT / "configs" / "planted_search_ft.yaml"
SID_TEST = ROOT / "configs" / "SID_test.yaml"
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
# Fast NLM's and the bilateral's backward kernels against the plain form's
# autograd, at every frame size: y and the clip's mask in the plain form's
# arithmetic, the gradient's sums in another order, and the params' a sum
# over every pixel and offset that cancels; 1e-4 of each gradient's
# largest value.
BACKWARD_KERNEL_RTOL = 1e-4
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
# tests/test_torch_windowed_median.py counts them in its mirror of the
# networks).
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


def fastnlm_backward_bound(x: torch.Tensor, params: torch.Tensor):
    """Least time for fast NLM's gradient for x and params on these inputs.
    Bytes: x, params and the cotangent read and gx and gp written once.
    Operations, as fastnlm_bound counts them, per pixel and channel over
    each image's own search window and distinct offset: the forward's 14
    and one exp to form the weight again (the op keeps no residuals), and
    for each of the two pixels the offset pairs the weight's gradient (a
    subtract and a multiply, 2), the box sum's (2), the adjoint box with
    running sums (5), the difference's 2 t gD (2) and three adds into gx
    (3): 28 more."""
    n, h, w, c = x.shape
    radii = kb.size01_to_radius(params[:, 1]).tolist()
    distinct = sum(((2 * s + 1) ** 2 - 1) // 2 for s in radii) * h * w * c
    moved = 3 * x.numel() * 4 + 2 * params.numel() * 4
    return _bound(moved, 42 * distinct, distinct)


def bilateral_backward_bound(x: torch.Tensor, params: torch.Tensor):
    """Least time for the bilateral's gradient for x and params on these
    inputs.  Bytes: x, params and the cotangent read and gx and gp written
    once.  Operations, as bilateral_bound counts them, over each image's
    own window: the forward's again to form the weights, N and D (the op
    keeps no residuals: 4 a tap, 3 a distinct exp, and the distinct exps),
    and 13 more a tap for the gradient: the weight's gradient (a subtract
    and two multiplies, 3), the centre's term (2) and its add (1), the
    tap's term A w - B (3), and the two params sums (4)."""
    n, h, w, c = x.shape
    radii = kb.size01_to_radius(params[:, 0]).tolist()
    taps = sum((2 * r + 1) ** 2 for r in radii) * h * w * c
    exps = sum(((2 * r + 1) ** 2 - 1) // 2 for r in radii) * h * w * c
    moved = 3 * x.numel() * 4 + 2 * params.numel() * 4
    return _bound(moved, 17 * taps + 3 * exps, exps)


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
    # phase 10's batches: yolo_search.yaml's 4 x 256 x 256 (the sRGB slots'
    # input) and yolo_isp.yaml's 2 x 512 x 512
    for n, size in ((4, 256), (2, 512)):
        shape = (n, size, size, 3)
        tag = f"yolo_{n}x{size}x{size}x3"
        for radii in ((1, 2, 3, 4), (4, 5, 6, 7)):
            rows = list(radii) if n == 4 else [radii[0], radii[-1]]
            span = f"{rows[0]}-{rows[-1]}"
            yield "bilateral", f"{tag}_r{span}", shape, rows, 4
            for b in (1, 4, 7):
                yield "fastnlm", f"{tag}_b{b}_s{span}", shape, rows, b
        for r in r17:
            yield "median", f"{tag}_r{r}", shape, [r] * n, 4


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
                 plain: bool = False, **trainer_kw) -> IspTrainer:
    """An IspTrainer on a pipeline with the bank's weights and the init
    logits, its kernel ops on their plain forms if `plain`; trainer_kw go to
    IspTrainer (a criterion and its target key)."""
    pipe = load_pipeline(dev, arch, use_proxy, bank)
    if plain:
        pipe.steps = _with_plain_kernels(pipe)
    return IspTrainer(pipe, train_opt, **trainer_kw)


def _train_run(trainer: IspTrainer, batch: dict, steps: int = TRAIN_STEPS,
               warmup: int = TRAIN_WARMUP) -> dict:
    """`steps` steps, with every count set to 0 just before the steps and
    read just after; the steps after `warmup` timed."""
    dev = trainer.pipeline.device
    start_logits = convert.state_to_jax(trainer.pipeline)["logits"]
    before = trainer.eval_loss(batch)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_counts()
    losses = []
    for step in range(steps):
        if step == warmup:
            start.record()
        losses.append(trainer.train_step(batch)["loss"])
    end.record()
    torch.cuda.synchronize()
    launches = _counts()
    return {"losses": losses, "before": before,
            "after": trainer.eval_loss(batch), "launches": launches,
            "ms": start.elapsed_time(end) / (steps - warmup),
            "peak_bytes": torch.cuda.max_memory_allocated(dev),
            "start_logits": start_logits,
            "logits": convert.state_to_jax(trainer.pipeline)["logits"]}


def phase_training(dev, bank):
    """Step-2 training of SID_isp's pipeline and of both kernel paths, with
    the kernels and with the plain forms; returns the kernels' forward
    launches over the kernel runs, and each path's ms per step with the
    kernels."""
    flagship, use_proxy, train_opt, n, size = sid_isp_options()
    batch = make_training_batch(dev, n, size)
    train_launches = {name: 0 for name in KERNELS}
    ms_per_step = {}
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
        ms_per_step[arch] = kern["ms"]
    return train_launches, ms_per_step


def phase_gradients(dev) -> None:
    """Each kernel's gradient through its custom op's autograd against the
    plain form's autograd, for x and params, of sum(k(x, p) g): at the
    training batch, where the backward is direct, bit for bit; at a
    1024-row frame, radius 7, where it goes by strips, within STRIP_TOL.
    Fast NLM's and the bilateral's, their backward kernels', within
    BACKWARD_KERNEL_RTOL at all three."""
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
            if name in ("fastnlm", "bilateral"):
                wmax = float(wx.abs().max())
                if not (dx <= BACKWARD_KERNEL_RTOL * wmax
                        and dp <= BACKWARD_KERNEL_RTOL * scale):
                    raise AssertionError(
                        f"{name} {case}: {dx}, {dp} > "
                        f"{BACKWARD_KERNEL_RTOL} of {wmax}, {scale}")
            elif shape[1] <= _vjp.DIRECT_ROWS:
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
                        order=None, ft=False, **trainer_kw):
    """A DartsTrainer (DartsFtTrainer with `ft`) on the supernet the options
    describe, omega from the bank, its kernel ops on their plain forms if
    `plain`; trainer_kw go to DartsTrainer (a criterion and its target
    key)."""
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
               if ft else DartsTrainer(net, train_opt, **trainer_kw))
    installed = trainer.load_pretrained(bank)
    missing = sorted(set(trainer.variables["omega"]) - set(installed))
    if missing:
        raise AssertionError(f"the bank lacks {missing}")
    return trainer


def _search_run(trainer, train, val, steps: int = SEARCH_STEPS,
                record: bool = False, warmup: int = SEARCH_WARMUP) -> dict:
    """`steps` search steps, with every count set to 0 just before the
    steps and read just after; steps after `warmup` timed.  With
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
        if step == warmup:
            start.record()
        logs.append(trainer.search_step(train, val))
        if record:
            trainer.record_intermediates()
    end.record()
    torch.cuda.synchronize()
    return {"logs": logs, "launches": _counts(),
            "ms": start.elapsed_time(end) / (steps - warmup),
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


def phase_search(dev, bank):
    """Step-1 search at SID_search's geometry; returns the kernels' launches
    in the second-order run with the kernels and remat on (the default), and
    that run's ms per step."""
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
    return kern["launches"], kern["ms"]


# ------------------------------------------------------------------ phase 9

# Phase 9: the entry points a user runs.  Cuts (steps, never geometry):
# proxy pretraining PRETRAIN_STEPS of the JAX default 1000; step 2 8 + 4 of
# SID_isp's 80,000; step 1 4 + 2 of SID_search's 200,000 and 3 of
# planted_search_ft's 1,500 (its tuning cadence cut from 50 to 3);
# evaluation EVAL_FRAMES frames.  The data: RECORD_PAIRS SID-size pairs made
# from seed 0, in place of the dataset.
PRETRAIN_STEPS = 20
PRETRAIN_OPS = ("bilateral", "median", "fastnlm", "bm3d")
# Pretraining losses, kernels vs plain forms, relative.  The first step's:
# the same weights on the same samples, the targets apart by the kernels'
# rounding order (at most 9.5e-7 bilateral, 4.8e-7 fast NLM, 0 median at
# 4x48x48x3, phase 3), which moves a mean over n = 8 x 48 x 48 x 3 = 55,296
# squared residuals r (|r| about 0.02) by about 2 x 1e-6 / (|r| sqrt(n)),
# 4e-7 of it; PRETRAIN_FIRST_RTOL leaves 25x.  The last step's: Adam's first
# steps move every weight by about lr sign(g), so a weight whose gradient
# lies within the targets' difference of 0 can step the other way in the
# other run, and 20 steps part such weights by up to 2 lr 20 = 0.04; the
# loss (about 4e-4) then moves by percents (2.0e-2 for the bilateral proxy
# in the first run on the card).  PRETRAIN_LAST_RTOL bounds that drift;
# the first step's check is the kernels' own.
PRETRAIN_FIRST_RTOL = 1e-5
PRETRAIN_LAST_RTOL = 1e-1
RECORD_FRAME = FRAME
RECORD_PAIRS = 4
ISP_STEPS, ISP_RESUMED, ISP_SAVE = 8, 12, 4
SEARCH_CLI_STEPS, SEARCH_CLI_RESUMED = 3, 4   # 4, 6 until phase 15 came
FT_CLI_STEPS = 3
EVAL_FRAMES = 2
EVAL_CHUNK = 4          # tiled_apply's default, which test.py takes
# Every CLI runs in a subprocess with TF32 off (NVIDIA_TF32_OVERRIDE=0), as
# this script's own phases run.
CLI_ENV = {"NVIDIA_TF32_OVERRIDE": "0"}
# python -c: run a module as `python -m` does, with the modules named in
# its first argument made unimportable, then print its process's kernel
# launches, peak device memory, torchrun rank and the network checkpoints
# it saved on a line of their own
_CLI_RUNNER = r"""
import json, os, runpy, sys
import torch
from reconfigisp_tpu_torch.ops.kernels import bilateral, fastnlm, median
from reconfigisp_tpu_torch.utils import checkpoint
saves = []
def _logged(save):
    def wrapper(*args, **kw):
        path = save(*args, **kw)
        saves.append(path)
        return path
    return wrapper
checkpoint.save_network = _logged(checkpoint.save_network)
for name in filter(None, sys.argv[1].split(",")):
    sys.modules[name] = None
module = sys.argv[2]
sys.argv = sys.argv[2:]
code = 0
try:
    runpy.run_module(module, run_name="__main__", alter_sys=True)
except SystemExit as exit_:
    code = exit_.code or 0
peak = torch.cuda.max_memory_allocated() if torch.cuda.is_available() else 0
print("CLI_COUNTS " + json.dumps({
    "launches": {"bilateral": bilateral.launches, "median": median.launches,
                 "fastnlm": fastnlm.launches}, "peak_bytes": peak,
    "rank": os.environ.get("RANK"), "saves": saves}),
      flush=True)
sys.exit(code)
"""


def _child_env() -> dict:
    """This process's environment with CLI_ENV, the checkout first on
    PYTHONPATH."""
    env = dict(os.environ, **CLI_ENV)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    return env


def run_cli(module: str, *args: str, without=(), timeout: int = 600) -> dict:
    """`python -m module args` in a subprocess from the checkout's root,
    the modules `without` unimportable there -> {"stdout", "launches",
    "peak_bytes", "seconds"}; raises on a non-zero exit."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", _CLI_RUNNER, ",".join(without), module,
         *args],
        cwd=str(ROOT), env=_child_env(), capture_output=True, text=True,
        timeout=timeout)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"{module} {' '.join(args)} exited "
                           f"{proc.returncode}:\n{proc.stdout[-3000:]}\n"
                           f"{proc.stderr[-6000:]}")
    counts = json.loads(re.findall(r"^CLI_COUNTS (.*)$", proc.stdout,
                                   re.M)[-1])
    return {"stdout": proc.stdout, "seconds": seconds, **counts}


def _summary(stdout: str) -> dict:
    """The dict train.py prints after "training done:"."""
    text = re.findall(r"^training done: (.*)$", stdout, re.M)[-1]
    return ast.literal_eval(text)


def _write_options(path: Path, opt: dict) -> str:
    path.write_text(yaml.safe_dump(opt))
    return str(path)


@contextlib.contextmanager
def plain_denoise():
    """ops.denoise's three kernel ops on their plain forms, where the
    registry's ops look them up."""
    saved = {name: getattr(denoise, name) for name in KERNELS}
    try:
        for name, (_, plain, *_) in KERNELS.items():
            setattr(denoise, name, plain)
        yield
    finally:
        for name, fn in saved.items():
            setattr(denoise, name, fn)


def make_sid_records(root: Path) -> str:
    """RECORD_PAIRS SID pairs, written with the port's PackedPairWriter from
    seed 0: a BGR GT (uint8) smooth over 16-pixel cells, and its RGGB mosaic
    at a tenth of the exposure with read noise, as a 14-bit raw (uint16).
    Keys name the exposures configs/SID_test.yaml selects (0.1s, 10s)."""
    h, w = RECORD_FRAME
    rng = np.random.default_rng(0)
    with PackedPairWriter(str(root), resolution=h) as writer:
        for i in range(RECORD_PAIRS):
            cells = rng.integers(16, 240, (-(-h // 16), -(-w // 16), 3),
                                 dtype=np.uint8)
            gt = np.repeat(np.repeat(cells, 16, 0), 16, 1)[:h, :w]
            mosaic = np.empty((h, w), np.float32)
            mosaic[0::2, 0::2] = gt[0::2, 0::2, 2]
            mosaic[0::2, 1::2] = gt[0::2, 1::2, 1]
            mosaic[1::2, 0::2] = gt[1::2, 0::2, 1]
            mosaic[1::2, 1::2] = gt[1::2, 1::2, 0]
            raw = mosaic * (16383.0 / 255.0 / 10.0) + rng.normal(
                0.0, 20.0, (h, w)).astype(np.float32)
            raw = np.clip(np.round(raw), 0, 16383).astype(np.uint16)
            writer.add_pair(f"{i:05d}_00_0.1s", raw, f"{i:05d}_00_10s",
                            np.ascontiguousarray(gt))
    return str(root)


def phase_pretrain(dev, bank, tmp: Path) -> dict:
    """9a: pretrain_modules on PRETRAIN_OPS at the JAX defaults (batch 8 of
    48x48), with the kernels as the targets and with the plain forms; ->
    the launches and the checkpoint: the bank with the four proxies
    replaced by the ones trained here."""
    reports = {}
    for mode in ("kernels", "plain"):
        report = {}
        ctx = plain_denoise() if mode == "plain" else contextlib.nullcontext()
        with ctx:
            torch.cuda.synchronize()
            _zero_counts()
            trained = pretrain_modules(
                PRETRAIN_STEPS, batch=8, size=48, ops=set(PRETRAIN_OPS),
                device=dev, verbose=False, report=report)
            torch.cuda.synchronize()
            launches = _counts()
        expected = {name: 0 if mode == "plain" else PRETRAIN_STEPS
                    for name in KERNELS}
        if launches != expected or sorted(report) != sorted(PRETRAIN_OPS):
            raise AssertionError(f"pretrain {mode}: launches {launches} != "
                                 f"{expected}, ops {sorted(report)}")
        reports[mode] = (report, launches, trained)
    kern, plain = reports["kernels"][0], reports["plain"][0]
    for op in PRETRAIN_OPS:
        rel = {k: abs(kern[op][k] - plain[op][k]) / abs(plain[op][k])
               for k in ("first_loss", "loss")}
        line("phase 9a pretrain", op=op, steps=PRETRAIN_STEPS, batch=8,
             size=48, s_per_step=f"{kern[op]['s_per_step']:.6f}",
             plain_s_per_step=f"{plain[op]['s_per_step']:.6f}",
             l2=f"{kern[op]['first_loss']:.9e}->{kern[op]['loss']:.9e}",
             plain_l2=f"{plain[op]['first_loss']:.9e}->"
                      f"{plain[op]['loss']:.9e}",
             first_rel_diff=f"{rel['first_loss']:.3e}",
             first_rtol=PRETRAIN_FIRST_RTOL,
             last_rel_diff=f"{rel['loss']:.3e}", last_rtol=PRETRAIN_LAST_RTOL)
        if not (math.isfinite(kern[op]["loss"])
                and rel["first_loss"] <= PRETRAIN_FIRST_RTOL
                and rel["loss"] <= PRETRAIN_LAST_RTOL):
            raise AssertionError(f"pretrain {op}: kernels {kern[op]} vs "
                                 f"plain forms {plain[op]}")
    launches = reports["kernels"][1]
    line("phase 9a pretrain launches",
         launches=json.dumps(launches).replace(" ", ""))
    path = save_network(str(tmp), "proxies", "pretrained",
                        {**bank, **reports["kernels"][2]})
    return {"launches": launches, "checkpoint": path}


def _isp_options(tmp: Path, records: str, niter: int) -> dict:
    opt = yaml.safe_load(SID_ISP.read_text())
    opt["network_G"]["architecture"] = SLICE2
    opt["datasets"]["train"].update(mode="SID_Records", dataroot=records)
    opt["train"]["niter"] = niter
    opt["logger"].update(save_checkpoint_freq=ISP_SAVE, print_freq=1)
    opt["path"] = {"root": str(tmp), "pretrain_proxies": str(BANK)}
    return opt


def _iter_walls(stdout: str) -> list:
    """train.py's per-iteration wall times (print_freq 1): the loop's whole
    iteration, the loader's wait included."""
    return [float(s) for s in re.findall(r"\(([0-9.]+)s/iter\)", stdout)]


def phase_train_cli(tmp: Path, records: str, phase7_ms: float) -> dict:
    """9b: step 2 through python -m reconfigisp_tpu_torch.train at
    SID_isp's geometry (slice 2, SID records): ISP_STEPS steps, then resumed
    to ISP_RESUMED; -> the launches and the last checkpoint."""
    runs = {}
    for niter in (ISP_STEPS, ISP_RESUMED):
        path = _write_options(tmp / f"isp_{niter}.yaml",
                              _isp_options(tmp, records, niter))
        run = run_cli("reconfigisp_tpu_torch.train", "--opt", path)
        summary = _summary(run["stdout"])
        steps_run = niter - (0 if niter == ISP_STEPS else ISP_STEPS)
        # a probe before and after the loop: eval_loss on its 2 samples,
        # then a forward of each; one launch of each kernel a step
        expected = {"bilateral": 0, "median": steps_run + 6,
                    "fastnlm": steps_run + 6}
        walls = _iter_walls(run["stdout"])
        tail = walls[len(walls) // 2:]
        wall = sum(tail) / len(tail)
        steady = summary["steady_s_per_iter"]
        line("phase 9b train.py", arch=SLICE2, niter=niter,
             steps=summary["steps"], steps_run=summary["steps_run"],
             loss=f"{summary['loss']:.6f}",
             probe_loss=f"{summary['probe_loss_start']:.6f}->"
                        f"{summary['probe_loss_final']:.6f}",
             steady_s_per_iter=steady,
             loop_s_per_iter=f"{wall:.4f}",
             loader_and_loop_share=f"{1.0 - steady / wall:.4f}",
             phase7_ms_per_step=f"{phase7_ms:.3f}",
             compile_s=summary["compile_s"],
             peak_mib=f"{run['peak_bytes'] / 2**20:.1f}",
             process_s=f"{run['seconds']:.2f}",
             launches=json.dumps(run["launches"]).replace(" ", ""))
        if summary["steps"] != niter or summary["steps_run"] != steps_run \
                or not math.isfinite(summary["loss"]):
            raise AssertionError(f"train.py niter {niter}: {summary}")
        if niter == ISP_RESUMED and "resumed from " not in run["stdout"]:
            raise AssertionError("train.py did not resume")
        if run["launches"] != expected:
            raise AssertionError(f"train.py launches {run['launches']} != "
                                 f"{expected}")
        runs[niter] = run
    ckpt = tmp / "experiments" / "SID_isp" / "models" / f"{ISP_RESUMED}_G.ckpt"
    total = {name: sum(r["launches"][name] for r in runs.values())
             for name in KERNELS}
    return {"launches": total, "checkpoint": str(ckpt)}


def phase_search_cli(tmp: Path, records: str, proxies: str,
                     phase8_ms: float) -> dict:
    """9c: step 1 through python -m reconfigisp_tpu_torch.train:
    SID_search.yaml on the records (SEARCH_CLI_STEPS steps, resumed to
    SEARCH_CLI_RESUMED), and
    planted_search_ft.yaml from 9a's proxies (3 steps, one tuning round);
    -> the launches."""
    total = {name: 0 for name in KERNELS}
    for niter in (SEARCH_CLI_STEPS, SEARCH_CLI_RESUMED):
        opt = yaml.safe_load(SID_SEARCH.read_text())
        opt["datasets"]["train"].update(mode="SID_Records", dataroot=records)
        opt["train"]["niter"] = niter
        opt["path"] = {"root": str(tmp), "pretrain_proxies": str(BANK)}
        run = run_cli("reconfigisp_tpu_torch.train", "--opt",
                      _write_options(tmp / f"search_{niter}.yaml", opt))
        summary = _summary(run["stdout"])
        steps_run = niter - (0 if niter == SEARCH_CLI_STEPS
                             else SEARCH_CLI_STEPS)
        expected = {name: 15 * steps_run for name in KERNELS}
        line("phase 9c train.py search", config="SID_search.yaml",
             niter=niter, steps=summary["steps"],
             steps_run=summary["steps_run"], loss=f"{summary['loss']:.6f}",
             val_loss=f"{summary['val_loss']:.6f}",
             steady_s_per_iter=summary.get("steady_s_per_iter"),
             phase8_ms_per_step=f"{phase8_ms:.3f}",
             architecture=summary["architecture"],
             launches_per_step=json.dumps({k: v / steps_run for k, v in
                                           run["launches"].items()})
             .replace(" ", ""),
             peak_mib=f"{run['peak_bytes'] / 2**20:.1f}",
             process_s=f"{run['seconds']:.2f}")
        if summary["steps"] != niter or summary["steps_run"] != steps_run \
                or run["launches"] != expected:
            raise AssertionError(f"search niter {niter}: {summary}, "
                                 f"launches {run['launches']}")
        for name in KERNELS:
            total[name] += run["launches"][name]

    opt = yaml.safe_load(PLANTED_SEARCH_FT.read_text())
    opt["proxy_ft_params"]["ft_interval"] = FT_CLI_STEPS
    opt["train"]["niter"] = FT_CLI_STEPS
    opt["path"] = {"root": str(tmp), "pretrain_proxies": proxies}
    run = run_cli("reconfigisp_tpu_torch.train", "--opt",
                  _write_options(tmp / "search_ft.yaml", opt))
    summary = _summary(run["stdout"])
    ft = {k: v for k, v in summary.items() if k.startswith("ft_")}
    ft_steps = opt["proxy_ft_params"]["ft_steps"]
    line("phase 9c train.py search", config="planted_search_ft.yaml",
         niter=FT_CLI_STEPS, steps=summary["steps"],
         loss=f"{summary['loss']:.6f}",
         steady_s_per_iter=summary.get("steady_s_per_iter"),
         architecture=summary["architecture"],
         ft_losses=json.dumps({k: round(v, 8) for k, v in ft.items()})
         .replace(" ", ""),
         target_launches=json.dumps(run["launches"]).replace(" ", ""),
         peak_mib=f"{run['peak_bytes'] / 2**20:.1f}",
         process_s=f"{run['seconds']:.2f}")
    if summary["steps"] != FT_CLI_STEPS or len(ft) != 8 \
            or not all(math.isfinite(v) for v in ft.values()) \
            or run["launches"] != {name: ft_steps for name in KERNELS}:
        raise AssertionError(f"planted_search_ft: {summary}, launches "
                             f"{run['launches']}")
    if "pretrained weights installed" not in run["stdout"]:
        raise AssertionError("planted_search_ft: no pretrained proxies")
    for name in KERNELS:
        total[name] += run["launches"][name]
    return {"launches": total}


def png_err(frame_u8: np.ndarray, want: np.ndarray) -> float:
    """How far a float frame in [0, 1] lies outside the rounding interval
    of each pixel of an 8-bit PNG: 0 where tensor2bgr(want) writes the
    file's values, else at least the float difference that moved them (the
    most an 8-bit file shows of a difference from `want`)."""
    written = frame_u8.astype(np.float64) / 255.0
    return float(np.maximum(np.abs(np.clip(want, 0.0, 1.0) - written)
                            - 0.5 / 255.0, 0.0).max())


def phase_eval_cli(dev, tmp: Path, records: str, checkpoint: str) -> dict:
    """9d: python -m reconfigisp_tpu_torch.test at SID_test.yaml's split
    geometry on EVAL_FRAMES full frames of the records with 9b's network,
    f32 then bf16 storage; the first frame's PNG held against
    make_serving_fn's output on the same weights; -> the launches."""
    outs, total = {}, {name: 0 for name in KERNELS}
    for storage in ("f32", "bf16"):
        opt = yaml.safe_load(SID_TEST.read_text())
        opt["name"] = f"SID_test_{storage}"
        opt["network_G"]["architecture"] = SLICE2
        opt["datasets"]["test"]["dataroot"] = records
        opt["precision"] = storage
        opt["path"] = {"root": str(tmp), "pretrain_model_G": checkpoint}
        # test.py writes each output frame as an 8-bit PNG (utils/png, no
        # cv2), which the check below holds to E2E_TOL as far as 8 bits show
        run = run_cli("reconfigisp_tpu_torch.test", "--opt",
                      _write_options(tmp / f"test_{storage}.yaml", opt),
                      "--max-images", str(EVAL_FRAMES), without=("cv2",))
        psnr_mean = float(re.findall(r"^psnr_mean=(.*)$", run["stdout"],
                                     re.M)[-1])
        frame_ms = [float(v) for v in re.findall(
            r"\] psnr [0-9.inf-]+ ssim [0-9.inf-]+ \(([0-9.]+) ms\)",
            run["stdout"])]
        n_tiles = (len(tile_positions(RECORD_FRAME[0], PATCH, STRIDE))
                   * len(tile_positions(RECORD_FRAME[1], PATCH, STRIDE)))
        calls = EVAL_FRAMES * -(-n_tiles // EVAL_CHUNK)
        expected = {"bilateral": 0, "median": calls, "fastnlm": calls}
        line("phase 9d test.py", arch=SLICE2, storage=storage,
             frames=EVAL_FRAMES, frame=RECORD_FRAME, patch=PATCH,
             stride=STRIDE, psnr_mean=psnr_mean,
             ms_per_frame=",".join(f"{v:.3f}" for v in frame_ms),
             peak_mib=f"{run['peak_bytes'] / 2**20:.1f}",
             process_s=f"{run['seconds']:.2f}",
             launches=json.dumps(run["launches"]).replace(" ", ""))
        if not math.isfinite(psnr_mean) or len(frame_ms) != EVAL_FRAMES \
                or run["launches"] != expected:
            raise AssertionError(f"test.py {storage}: psnr {psnr_mean}, "
                                 f"{frame_ms}, launches {run['launches']}")
        outs[storage] = png.read(tmp / "results" / opt["name"] / "0000.png")
        for name in KERNELS:
            total[name] += run["launches"][name]

    ds_opt = dict(opt["datasets"]["test"], is_train=False)
    sample = create_dataset(ds_opt)[0]
    pipe = Pipeline(SLICE2, device=dev)
    pipe.load_state(convert.state_from_jax(load_network(checkpoint)))
    serve = make_serving_fn(pipe, patch=PATCH, stride=STRIDE,
                            chunk=EVAL_CHUNK, device=dev)
    want = serve(sample["noisy"][None])[0].cpu().numpy()
    diff = png_err(outs["f32"], want)
    bf16_diff = float(np.abs(outs["bf16"].astype(np.int64)
                             - outs["f32"]).max()) / 255.0
    line("phase 9d test.py vs make_serving_fn", frame=tuple(want.shape),
         max_abs_diff=f"{diff:.3e}", tol=E2E_TOL,
         bf16_vs_f32=f"{bf16_diff:.3e}", bf16_tol=BF16_TOL,
         range=f"{float(want.min()):.4f}..{float(want.max()):.4f}")
    if not (diff <= E2E_TOL and bf16_diff <= BF16_TOL):
        raise AssertionError(f"test.py output: {diff}, bf16 {bf16_diff}")
    return {"launches": total}


def phase_entry_points(dev, bank, phase7_ms: float, phase8_ms: float,
                       tmp: Path):
    """Phase 9: the port's entry points on the card, each counted from 0
    in its own process: 9a proxy pretraining (in this process), 9b step 2,
    9c step 1 (beside 9b and 9d), 9d evaluation, under `tmp`, where the
    records and 9c's run stay for phase 13e.  -> {"pretrain": launches, "entry": launches of
    9b-9d}."""
    t0 = time.perf_counter()
    pre = phase_pretrain(dev, bank, tmp)
    records = make_sid_records(tmp / "records")
    line("phase 9 records", pairs=RECORD_PAIRS, frame=RECORD_FRAME,
         mib=f"{sum(f.stat().st_size for f in (tmp / 'records').iterdir()) / 2**20:.1f}",
         seconds=f"{time.perf_counter() - t0:.2f}")
    # 9c's processes beside 9b's and 9d's (9d reads 9b's checkpoint): their
    # s a step are taken under each other's load
    with ThreadPoolExecutor(1) as pool:
        searched = pool.submit(phase_search_cli, tmp, records,
                               pre["checkpoint"], phase8_ms)
        train = phase_train_cli(tmp, records, phase7_ms)
        evals = phase_eval_cli(dev, tmp, records, train["checkpoint"])
        search = searched.result()
    entry = {name: train["launches"][name] + search["launches"][name]
             + evals["launches"][name] for name in KERNELS}
    line("phase 9 launches", pretrain=json.dumps(pre["launches"])
         .replace(" ", ""), train=json.dumps(train["launches"])
         .replace(" ", ""), search=json.dumps(search["launches"])
         .replace(" ", ""), eval=json.dumps(evals["launches"])
         .replace(" ", ""), seconds=f"{time.perf_counter() - t0:.2f}")
    return {"pretrain": pre["launches"], "entry": entry}


# ----------------------------------------------------------------- phase 10

YOLO_SEARCH = ROOT / "configs" / "yolo_search.yaml"
YOLO_ISP = ROOT / "configs" / "yolo_isp.yaml"
YOLO_TEST = ROOT / "configs" / "yolo_test.yaml"
# Phase 10: detection-driven search, training and evaluation under the frozen
# 80-class YOLOv3 at the configs' own geometry.  Cuts: synthetic_yolo frames
# in place of the OnePlus folders (YOLO_FRAMES for the search, the batch for
# training, YOLO_TEST_FRAMES for evaluation); the port's seeded YOLOv3 init,
# written as a darknet file, in place of yolov3.weights; steps: the search
# 2 then resumed to 3 of 40,000 through train.py (3 and 4 until phase 15
# came) and 2 in process (cut from 3 when phase 14 came), training 4 of
# 8,000: cuts to hold the script's time.
YOLO_FRAMES = 16
YOLO_SEARCH_STEPS, YOLO_SEARCH_RESUMED = 2, 3
YOLO_INPROC_STEPS = 2
YOLO_ISP_STEPS = 4
YOLO_TEST_FRAMES = 4
YOLO_CARD_SHAPE = (1, 256, 256, 3)
# YOLOv3 on the card against the CPU, TF32 off: 75 f32 convs whose sums
# cuDNN and the CPU take in other orders, each a relative rounding of about
# 1e-7 of its output; the seeded init contracts the signal (weights
# U(+-sqrt(1/fan_in)) scale its variance by about 1/3 a conv, the shortcuts
# add it back), so the heads are of order 0.05 and their errors are
# relative.  Held to 1e-4 of each head's largest magnitude: about 100x a
# growth of 1e-7 a layer over 75 layers.
YOLO_CARD_RTOL = 1e-4
# The search, kernels vs plain forms, over YOLO_INPROC_STEPS second-order
# steps (written before the first run).  The kernels differ from the plain
# forms by rounding order, at most 2e-5 (bilateral) and 5e-5 (fast NLM) a
# value, 0 (median), in candidates weighted 1/15 in each of 3 slots: an
# output error of about 1e-5, of either sign from value to value, into the
# detector.
#  * Losses, relative: the YOLO loss (noobj_scale 100) is a sum of BCE over
#    4 x 3 x (8^2 + 16^2 + 32^2) = 16,128 cells, each a smooth function of
#    the frame through 75 contracting convs; errors of either sign average
#    out, so it moves by far less than 1e-5 of itself; YOLO_LOSS_RTOL 1e-5.
#  * Alphas: as phase 8, Adam moves an alpha by lr times a ratio of moments
#    that a relative gradient error e of about 1e-4 moves by about e: 3 steps
#    (now 2) at lr 1e-4 part them by about 3e-8; YOLO_ALPHA_TOL 1e-5.
#  * Theta: SGD moves theta by lr times the gradient, which the detection
#    loss makes large (of order 1e3-1e4, against about 1 for phase 8's l2),
#    so the parting scales with the move: e of it, 1e-4; held to
#    YOLO_THETA_RTOL 1e-3 of the largest theta move.
YOLO_LOSS_RTOL = 1e-5
YOLO_ALPHA_TOL = 1e-5
YOLO_THETA_RTOL = 1e-3
# Training, kernels vs plain forms, over YOLO_ISP_STEPS Adam steps at lr
# 1e-3: each logit moves by about lr a step whatever the gradient's scale,
# and a relative gradient error of 1e-4 parts two runs by about
# lr 1e-4 = 1e-7 a step; YOLO_LOGIT_TOL 1e-4 (phase 7's), losses as above.
YOLO_LOGIT_TOL = 1e-4
# test.py's detections of the first frame against an in-process decode and
# NMS of its saved output frame on the same weights: the same convs on the
# same card, predicted equal; cuDNN may take another algorithm in another
# process (boxes 7.6e-6 px apart, of up to 1024 px, on an H100 80GB HBM3).
# Held to 1e-4.
YOLO_DETS_TOL = 1e-4


def yolo_forward_flops(blocks, h: int, w: int) -> int:
    """FP32 operations of one YoloNet forward on one h x w image: 2 per
    multiply-add of each conv (Cin k^2 Cout per output pixel)."""
    channels, sizes, flops = [3], [(h, w)], 0
    for i, blk in enumerate(blocks):
        t, (hh, ww) = blk["type"], sizes[-1]
        if t == "convolutional":
            s, k = blk["stride"], blk["size"]
            hh, ww = -(-hh // s), -(-ww // s)
            flops += 2 * channels[-1] * k * k * blk["filters"] * hh * ww
            channels.append(blk["filters"])
        elif t == "route":
            idx = [l if l >= 0 else i + l for l in blk["layers"]]
            channels.append(sum(channels[j + 1] for j in idx))
            hh, ww = sizes[idx[0] + 1]
        else:
            if t == "upsample":
                hh, ww = 2 * hh, 2 * ww
            channels.append(channels[-1])
        sizes.append((hh, ww))
    return flops


def write_yolo_weights(tmp: Path):
    """The 80-class YOLOv3 from the port's init (seed 0), written in the
    darknet format -> (blocks, path)."""
    blocks = ycfg.yolov3_blocks(80)
    net = init_yolo(blocks, torch.Generator().manual_seed(0))
    path = tmp / "yolov3.weights"
    save_darknet_weights(net, str(path))
    return blocks, str(path)


def phase_yolo_card_vs_cpu(dev, blocks, weights: str) -> None:
    """load_darknet_weights at full size, then the forward on the card
    against the CPU on one YOLO_CARD_SHAPE input."""
    x = torch.rand(YOLO_CARD_SHAPE, generator=torch.Generator().manual_seed(5))
    t0 = time.perf_counter()
    card = load_darknet_weights(blocks, weights, device=dev)
    load_s = time.perf_counter() - t0
    cpu = load_darknet_weights(blocks, weights)
    with torch.no_grad():
        got = card(x.to(dev))
        want = cpu(x)
    worst = 0.0
    for (g, _, _), (w, _, _) in zip(got, want):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError("YOLOv3 on the card: non-finite head")
        worst = max(worst, float((g.cpu() - w).abs().max())
                    / float(w.abs().max()))
    line("phase 10 yolov3 card vs cpu", input=YOLO_CARD_SHAPE,
         convs=len(card.conv_blocks()),
         floats=sum(p.numel() for p in card.parameters()),
         file_mib=f"{os.path.getsize(weights) / 2**20:.1f}",
         load_s=f"{load_s:.2f}",
         heads=[tuple(h.shape) for h, _, _ in got],
         max_rel_diff=f"{worst:.3e}", rtol=YOLO_CARD_RTOL,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    if not worst <= YOLO_CARD_RTOL:
        raise AssertionError(f"YOLOv3 card vs CPU: {worst} > {YOLO_CARD_RTOL}")


def _yolo_options(path: Path, tmp: Path, weights: str,
                  dataset: dict) -> dict:
    """A yolo config as it stands, its dataset updated to synthetic frames
    (`dataset`), the darknet file as its weights, the paths under tmp."""
    opt = yaml.safe_load(path.read_text())
    ds_key = "train" if "train" in opt["datasets"] else "test"
    opt["datasets"][ds_key].update(mode="synthetic_yolo", **dataset)
    opt["datasets"][ds_key].pop("dataroot", None)
    opt["yolo"]["weights"] = weights
    opt["path"] = {**(opt.get("path") or {}), "root": str(tmp)}
    return opt


def _yolo_batch(opt: dict, start: int, n: int, dev) -> dict:
    """Frames start..start+n-1 of the options' synthetic_yolo dataset as a
    batch on the card: noisy mosaics and labels."""
    ds_opt = dict(opt["datasets"]["train"])
    ds_opt.setdefault("seed", opt["train"]["manual_seed"] or 0)
    ds = create_dataset(ds_opt)
    samples = [ds[i] for i in range(start, start + n)]
    return {k: torch.from_numpy(np.stack([s[k] for s in samples])).to(dev)
            for k in ("noisy", "label")}


def phase_yolo_search_cli(tmp: Path, weights: str) -> dict:
    """10a: configs/yolo_search.yaml through python -m
    reconfigisp_tpu_torch.train (YOLO_SEARCH_STEPS, then resumed to
    YOLO_SEARCH_RESUMED).  -> launches."""
    total = {name: 0 for name in KERNELS}
    dataset = {"n": YOLO_FRAMES}
    for niter in (YOLO_SEARCH_STEPS, YOLO_SEARCH_RESUMED):
        opt = _yolo_options(YOLO_SEARCH, tmp, weights, dataset)
        opt["train"]["niter"] = niter
        opt["path"]["pretrain_proxies"] = str(BANK)
        run = run_cli("reconfigisp_tpu_torch.train", "--opt", _write_options(
            tmp / f"yolo_search_{niter}.yaml", opt))
        summary = _summary(run["stdout"])
        steps_run = niter - (0 if niter == YOLO_SEARCH_STEPS
                             else YOLO_SEARCH_STEPS)
        expected = {name: 15 * steps_run for name in KERNELS}
        line("phase 10a train.py darts_yolo", config="yolo_search.yaml",
             niter=niter, steps=summary["steps"],
             steps_run=summary["steps_run"], loss=f"{summary['loss']:.6f}",
             val_loss=f"{summary['val_loss']:.6f}",
             steady_s_per_iter=summary.get("steady_s_per_iter"),
             compile_s=summary.get("compile_s"),
             architecture=summary["architecture"],
             launches=json.dumps(run["launches"]).replace(" ", ""),
             peak_mib=f"{run['peak_bytes'] / 2**20:.1f}",
             process_s=f"{run['seconds']:.2f}")
        if summary["steps"] != niter or summary["steps_run"] != steps_run \
                or not math.isfinite(summary["loss"]) \
                or run["launches"] != expected:
            raise AssertionError(f"darts_yolo niter {niter}: {summary}, "
                                 f"launches {run['launches']}")
        if niter == YOLO_SEARCH_RESUMED and "resumed from " not in \
                run["stdout"]:
            raise AssertionError("darts_yolo did not resume")
        for name in KERNELS:
            total[name] += run["launches"][name]
    return total


def phase_yolo_search(dev, bank, tmp: Path, weights: str) -> dict:
    """10a: configs/yolo_search.yaml in process with the kernels and with
    the plain forms; the argmax architecture served.  -> launches."""
    total = {name: 0 for name in KERNELS}
    dataset = {"n": YOLO_FRAMES}
    opt = config.parse_dict(_yolo_options(YOLO_SEARCH, tmp, weights, dataset),
                            root=str(tmp))
    n, size = opt["datasets"]["train"]["batch_size"], \
        opt["datasets"]["train"]["data_size"]
    train = _yolo_batch(opt, 0, n, dev)
    val = _yolo_batch(opt, n, n, dev)
    detector = build_yolo_evaluator(opt["yolo"], dev)
    criterion = make_yolo_criterion(detector, size)
    runs = {}
    for what, plain in (("kernels", False), ("plain", True)):
        trainer = make_search_trainer(dev, bank, opt, plain=plain,
                                      criterion=criterion, target_key="label")
        run = _search_run(trainer, train, val, YOLO_INPROC_STEPS, warmup=1)
        run["trainer"] = trainer
        runs[what] = run
        losses = [lg["loss"] for lg in run["logs"]]
        line("phase 10a darts_yolo", run=what, batch=tuple(train["noisy"].shape),
             steps=YOLO_INPROC_STEPS, ms_per_step=f"{run['ms']:.3f}",
             peak_mib=f"{run['peak_bytes'] / 2**20:.1f}",
             loss=f"{losses[0]:.6f}->{losses[-1]:.6f}",
             launches_per_step=json.dumps({k: v / YOLO_INPROC_STEPS for k, v
                                           in run["launches"].items()})
             .replace(" ", ""))
        expected = {name: 0 if plain else 15 * YOLO_INPROC_STEPS
                    for name in KERNELS}
        if run["launches"] != expected or not all(
                math.isfinite(v) for lg in run["logs"] for v in lg.values()):
            raise AssertionError(f"darts_yolo {what}: {run['logs']}, "
                                 f"launches {run['launches']}")
    kern, ref = runs["kernels"], runs["plain"]
    loss_diff = max(abs(a[k] - b[k]) / abs(b[k])
                    for a, b in zip(kern["logs"], ref["logs"])
                    for k in ("loss", "val_loss"))
    kv, rv = kern["trainer"].variables, ref["trainer"].variables
    start = make_search_trainer(dev, bank, opt).variables
    alpha_diff = _max_diff(kv["alphas"], rv["alphas"])
    theta_diff = _max_diff(kv["theta"], rv["theta"])
    theta_move = _max_diff(kv["theta"], start["theta"])
    line("phase 10a kernels vs plain", steps=YOLO_INPROC_STEPS,
         max_loss_rel_diff=f"{loss_diff:.3e}", loss_rtol=YOLO_LOSS_RTOL,
         max_alpha_diff=f"{alpha_diff:.3e}", alpha_tol=YOLO_ALPHA_TOL,
         max_theta_diff=f"{theta_diff:.3e}",
         theta_tol=f"{YOLO_THETA_RTOL * theta_move:.3e}",
         max_alpha_move=f"{_max_diff(kv['alphas'], start['alphas']):.3e}",
         max_theta_move=f"{theta_move:.3e}")
    if not (loss_diff <= YOLO_LOSS_RTOL and alpha_diff <= YOLO_ALPHA_TOL
            and theta_diff <= YOLO_THETA_RTOL * theta_move):
        raise AssertionError("darts_yolo: kernels vs plain forms part")
    for name in KERNELS:
        total[name] += kern["launches"][name]

    # the detector's part of a step: each of the 5 passes runs its forward
    # and its input backward on the batch
    x = torch.rand((n, size, size, 3), device=dev,
                   generator=torch.Generator(device=dev).manual_seed(6))

    def yolo_pass():
        xs = x.clone().requires_grad_()
        torch.autograd.grad(criterion(xs, train["label"]), xs)

    pass_ms = event_ms(yolo_pass, reps=5)
    flops = 2 * n * yolo_forward_flops(detector.blocks, size, size)
    line("phase 10a yolov3 pass", batch=tuple(x.shape), ms=f"{pass_ms:.3f}",
         tflop=f"{flops / 1e12:.4f}",
         tflop_per_s=f"{flops / pass_ms / 1e9:.2f}",
         passes_per_step=5,
         share_of_step=f"{5 * pass_ms / kern['ms']:.4f}",
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)

    arch = kern["trainer"].architecture()
    pipe = load_pipeline(dev, arch, bank=bank)
    with torch.inference_mode():
        y = pipe(val["noisy"])
        served_loss = float(criterion(y, val["label"]))
    if tuple(y.shape) != (n, size, size, 3) or not bool(
            torch.isfinite(y).all()) or not math.isfinite(served_loss):
        raise AssertionError(f"{arch}: output {tuple(y.shape)}")
    line("phase 10a architecture", arch=arch, out=tuple(y.shape),
         range=f"{float(y.min()):.4f}..{float(y.max()):.4f}",
         yolo_loss=f"{served_loss:.6f}")
    return total


def phase_yolo_training(dev, bank, tmp: Path, weights: str) -> dict:
    """10b: configs/yolo_isp.yaml (batch 2 of 512x512, Adam lr 1e-3) on one
    synthetic batch, YOLO_ISP_STEPS steps: its flagship with the kernels,
    slice 2 with the kernels and with the plain forms.  -> the launches and
    slice 2's checkpoint."""
    opt = config.parse_dict(_yolo_options(YOLO_ISP, tmp, weights, {}),
                            root=str(tmp))
    data = opt["datasets"]["train"]
    n, size = data["batch_size"], data["data_size"]
    batch = _yolo_batch(opt, 0, n, dev)
    criterion = make_yolo_criterion(build_yolo_evaluator(opt["yolo"], dev),
                                    size)
    use_proxy = config.network_uses_proxy(opt["network_G"])
    flagship = opt["network_G"]["architecture"]
    runs = {}
    for arch, plain in ((flagship, False), (SLICE2, False), (SLICE2, True)):
        trainer = make_trainer(dev, arch, use_proxy, bank, opt["train"], plain,
                               criterion=criterion, target_key="label")
        run = _train_run(trainer, batch, YOLO_ISP_STEPS, warmup=1)
        run["trainer"] = trainer
        runs[arch, plain] = run
        mode = "plain" if plain else "kernels"
        line("phase 10b isp_yolo", arch=arch, mode=mode,
             batch=tuple(batch["noisy"].shape), steps=YOLO_ISP_STEPS,
             ms_per_step=f"{run['ms']:.3f}",
             peak_mib=f"{run['peak_bytes'] / 2**20:.1f}",
             eval_loss=f"{run['before']:.6f}->{run['after']:.6f}",
             launches=json.dumps(run["launches"]).replace(" ", ""))
        kernels = PATHS.get(arch, ()) if not plain else ()
        expected = {name: YOLO_ISP_STEPS if name in kernels else 0
                    for name in KERNELS}
        if run["launches"] != expected or not all(
                math.isfinite(v) for v in run["losses"]):
            raise AssertionError(f"isp_yolo {arch} {mode}: {run['losses']}, "
                                 f"launches {run['launches']}")
        if not run["after"] < run["before"]:
            raise AssertionError(f"isp_yolo {arch} {mode}: eval loss "
                                 f"{run['before']} -> {run['after']}")
    kern, ref = runs[SLICE2, False], runs[SLICE2, True]
    diff = max(float(abs(kern["logits"][k] - ref["logits"][k]).max())
               for k in ref["logits"])
    moved = max(float(abs(v - kern["start_logits"][k]).max())
                for k, v in kern["logits"].items())
    loss_diff = max(abs(a - b) / abs(b)
                    for a, b in zip(kern["losses"], ref["losses"]))
    line("phase 10b kernels vs plain logits", arch=SLICE2,
         max_abs_diff=f"{diff:.3e}", tol=YOLO_LOGIT_TOL,
         max_logit_move=f"{moved:.3e}",
         max_loss_rel_diff=f"{loss_diff:.3e}", loss_rtol=YOLO_LOSS_RTOL)
    if not (diff <= YOLO_LOGIT_TOL and loss_diff <= YOLO_LOSS_RTOL):
        raise AssertionError(f"isp_yolo: logits {diff}, losses "
                             f"{kern['losses']} vs {ref['losses']}")
    models = tmp / "experiments" / "yolo_isp"
    kern["trainer"].save(str(models / "models"),
                         str(models / "training_state"), 0)
    return {"launches": kern["launches"],
            "checkpoint": str(models / "models" / f"{YOLO_ISP_STEPS}_G.ckpt")}


def phase_yolo_eval(dev, tmp: Path, weights: str, checkpoint: str) -> dict:
    """10c: configs/yolo_test.yaml (whole 1024x1024 frames, conf_thres
    0.005) through python -m reconfigisp_tpu_torch.test on
    YOLO_TEST_FRAMES synthetic frames with 10b's slice 2 network; the first
    frame run again in process: its PNG held against that output, its
    detections against an in-process decode and NMS.  -> launches."""
    opt = _yolo_options(YOLO_TEST, tmp, weights, {"n": YOLO_TEST_FRAMES})
    opt["network_G"]["architecture"] = SLICE2
    opt["path"]["pretrain_model_G"] = checkpoint
    run = run_cli("reconfigisp_tpu_torch.test", "--opt",
                  _write_options(tmp / "yolo_test.yaml", opt),
                  without=("cv2",))
    found = re.findall(r"^map=([0-9.]+)$", run["stdout"], re.M)
    frame_ms = [float(v) for v in re.findall(
        r"\] detections \d+ \(([0-9.]+) ms\)", run["stdout"])]
    ds = opt["datasets"]["test"]
    expected = {name: YOLO_TEST_FRAMES if name in PATHS[SLICE2] else 0
                for name in KERNELS}
    results = tmp / "results" / opt["name"]
    frame_png = png.read(results / "0000.png")
    dets = np.load(results / "0000_dets.npy")
    # the first frame again in process, the output the file was written from
    pipe = Pipeline(SLICE2, device=dev)
    pipe.load_state(convert.state_from_jax(load_network(checkpoint)))
    pipe.eval()
    sample = create_dataset(dict(ds, is_train=False))[0]
    detector = build_yolo_evaluator(opt["yolo"], dev)
    with torch.inference_mode():
        frame = pipe(torch.from_numpy(sample["noisy"][None]).to(dev))[0]
        heads = detector(frame[None].float().flip(-1))
        frame = frame.float().cpu().numpy()
    want = ytrain.detections(heads, frame.shape[0], ds["conf_thres"])[0]
    diff = float(np.abs(dets - want).max()) if dets.shape == want.shape \
        else math.inf
    frame_diff = png_err(frame_png, frame)
    line("phase 10c test.py isp_yolo", config="yolo_test.yaml", arch=SLICE2,
         frames=YOLO_TEST_FRAMES, frame=tuple(frame.shape),
         conf_thres=ds["conf_thres"], map=found[-1] if found else None,
         detections=len(dets), ms_per_frame=",".join(f"{v:.3f}"
                                                     for v in frame_ms),
         dets_vs_in_process=f"{diff:.3e}", dets_tol=YOLO_DETS_TOL,
         png_vs_in_process=f"{frame_diff:.3e}", png_tol=E2E_TOL,
         peak_mib=f"{run['peak_bytes'] / 2**20:.1f}",
         process_s=f"{run['seconds']:.2f}",
         launches=json.dumps(run["launches"]).replace(" ", ""))
    if len(found) != 1 or not math.isfinite(float(found[0])) \
            or len(frame_ms) != YOLO_TEST_FRAMES \
            or run["launches"] != expected or not diff <= YOLO_DETS_TOL \
            or not frame_diff <= E2E_TOL \
            or frame_png.shape != (ds["data_size"], ds["data_size"], 3):
        raise AssertionError(f"yolo test.py: map {found}, frames {frame_ms}, "
                             f"launches {run['launches']}, dets {diff}")
    return run["launches"]


def phase_yolo(dev, bank) -> dict:
    """Phase 10: the detection path under the frozen YOLOv3; -> the
    kernels' launches over 10a-10c."""
    with tempfile.TemporaryDirectory() as root:
        tmp = Path(root)
        t0 = time.perf_counter()
        blocks, weights = write_yolo_weights(tmp)
        # 10a's CLI processes beside the in-process runs: the ms a step,
        # TFLOP/s and process seconds of phase 10 are taken under each
        # other's load
        with ThreadPoolExecutor(1) as pool:
            clis = pool.submit(phase_yolo_search_cli, tmp, weights)
            phase_yolo_card_vs_cpu(dev, blocks, weights)
            search = phase_yolo_search(dev, bank, tmp, weights)
            training = phase_yolo_training(dev, bank, tmp, weights)
            evals = phase_yolo_eval(dev, tmp, weights,
                                    training["checkpoint"])
            search_cli = clis.result()
        total = {name: search_cli[name] + search[name]
                 + training["launches"][name] + evals[name]
                 for name in KERNELS}
        line("phase 10 launches",
             search_cli=json.dumps(search_cli).replace(" ", ""),
             search=json.dumps(search).replace(" ", ""),
             train=json.dumps(training["launches"]).replace(" ", ""),
             eval=json.dumps(evals).replace(" ", ""),
             seconds=f"{time.perf_counter() - t0:.2f}")
    return total


# ----------------------------------------------------------------- phase 11

# Phase 11: the deployment path, from a camera file to a served frame, at
# SID's Sony geometry (FRAME).  Cuts: INGEST_PAIRS pairs of the dataset's
# 2,697 short/long pairs, made from seed 0 in place of the camera's files.
FLAGSHIP = "Bayer_01_Demosaic_03_sRGB_01_13_11"
INGEST_PAIRS = 2
INGEST_PATCH = 512
INGEST_RATIO = 100.0          # SID's 0.1 s short to 10 s long exposure
SID_BLACK, SID_WHITE = 512, 16383   # the Sony raws' 14-bit black and white
RAWPROC_TOL = 1e-6            # tests/test_native.py: native vs numpy forms
ARTIFACT_TOL = 1e-4           # ROADMAP.md's serving-artifact gate, vs serving fn
ARTIFACT_REPS = 3             # timed frames after the first, per artifact
# python -c: load an artifact with deploy alone, serve a frame, save it;
# print the launches of that first frame (counted from 0 at the start of
# the process, as run_cli counts), ms a frame over `reps` more (CUDA
# events), and the modules of the JAX package, the op zoo or the pipeline it
# imported (there must be none)
_ARTIFACT_RUNNER = r"""
import json, sys, time
t0 = time.perf_counter()
import numpy as np
import torch
from reconfigisp_tpu_torch import deploy
from reconfigisp_tpu_torch.ops.kernels import bilateral, fastnlm, median
def counts():
    return {"bilateral": bilateral.launches, "median": median.launches,
            "fastnlm": fastnlm.launches}
path, frame, out, reps = sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4])
served = deploy.load_pipeline(path)
x = torch.from_numpy(np.load(frame)).to(served.device)
y = served(x)
torch.cuda.synchronize()
first = counts()
first_s = time.perf_counter() - t0
np.save(out, y.cpu().numpy())
start = torch.cuda.Event(enable_timing=True)
end = torch.cuda.Event(enable_timing=True)
start.record()
for _ in range(reps):
    served(x)
end.record()
torch.cuda.synchronize()
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "reconfigisp_tpu")
             or m in ("reconfigisp_tpu_torch.pipeline", "reconfigisp_tpu_torch.registry"))
print("ARTIFACT " + json.dumps({
    "first_launches": first, "launches": counts(),
    "ms": start.elapsed_time(end) / reps, "seconds_to_first_frame": first_s,
    "imported": bad, "peak_bytes": torch.cuda.max_memory_allocated()}),
      flush=True)
"""


def _host_ms(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, 1e3 * (time.perf_counter() - t0)


def phase_rawproc() -> None:
    """11a: build native/rawproc.cpp with g++ here, and hold its four
    functions against their numpy forms on a SID-size uint16 frame from
    seed 0, within RAWPROC_TOL (host times beside)."""
    lib, build_ms = _host_ms(rawproc.build)
    line("phase 11a rawproc build", library=lib.name,
         seconds=f"{build_ms / 1e3:.2f}", flags=" ".join(rawproc.CXX_FLAGS))
    rng = np.random.default_rng(0)
    h, w = FRAME
    raw = rng.integers(0, SID_WHITE + 1, (2, h, w), dtype=np.uint16)
    offsets = np.stack([rng.integers(0, h - INGEST_PATCH, 8),
                        rng.integers(0, w - INGEST_PATCH, 8)], 1)
    mosaic = rawproc.normalize_u16(raw[0], SID_BLACK, SID_WHITE)
    ys, xs = (tile_positions(h, PATCH, STRIDE), tile_positions(w, PATCH, STRIDE))
    positions = np.asarray([(y, x) for y in ys for x in xs], np.int32)
    patches = np.repeat(np.stack([mosaic[y:y + PATCH, x:x + PATCH]
                                  for y, x in positions])[..., None], 3, -1)
    mask = feather_mask((PATCH, PATCH), ((PATCH - STRIDE) // 2,) * 2)
    cases = {
        "normalize_u16": ((raw[0], SID_BLACK, SID_WHITE, 2.5), {}),
        "crop_norm_batch": ((np.repeat(raw, 4, 0), offsets, INGEST_PATCH,
                             SID_BLACK, SID_WHITE, 2.5), {}),
        "pack_rggb": ((mosaic,), {}),
        "feather_accumulate": ((patches, positions, mask, h, w), {}),
    }
    for name, (args, kw) in cases.items():
        got, ms = _host_ms(lambda: getattr(rawproc, name)(*args, **kw))
        want, plain_ms = _host_ms(
            lambda: getattr(rawproc, f"{name}_plain")(*args, **kw))
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        err = max(float(np.abs(a - b).max()) for a, b in zip(got, want))
        line("phase 11a rawproc vs numpy", fn=name,
             shape=tuple(np.shape(args[0])), max_abs_err=f"{err:.3e}",
             tol=RAWPROC_TOL, native_ms=f"{ms:.2f}",
             numpy_ms=f"{plain_ms:.2f}")
        if not err <= RAWPROC_TOL:
            raise AssertionError(f"rawproc {name}: {err} > {RAWPROC_TOL}")


def write_dng_pairs(root: Path):
    """INGEST_PAIRS SID-size 14-bit DNG pairs from seed 0: a long exposure
    of a BGR scene smooth over 16-pixel cells, mosaicked RGGB between the
    black and white levels, and a short one at 1 / INGEST_RATIO of it with
    read noise.  Each is read back and must be bit-exact.  -> (short paths,
    long paths, bytes written)."""
    h, w = FRAME
    rng = np.random.default_rng(0)
    shorts, longs, nbytes = [], [], 0
    for i in range(INGEST_PAIRS):
        cells = rng.uniform(0.05, 0.95, (-(-h // 16), -(-w // 16), 3))
        bgr = np.repeat(np.repeat(cells, 16, 0), 16, 1)[:h, :w]
        scene = SyntheticRawDataset.mosaic_rggb(bgr.astype(np.float32))[..., 0]
        long_ = SID_BLACK + scene * (SID_WHITE - SID_BLACK)
        short = SID_BLACK + (long_ - SID_BLACK) / INGEST_RATIO + rng.normal(
            0.0, 8.0, (h, w))
        for kind, value, paths in (("short", short, shorts),
                                   ("long", long_, longs)):
            mosaic = np.clip(np.round(value), 0, SID_WHITE).astype(np.uint16)
            path = root / f"{i:05d}_00_{kind}.dng"
            dng.write_dng(str(path), mosaic, black=SID_BLACK, white=SID_WHITE,
                          bits=14, as_shot_neutral=[0.5, 1.0, 0.6])
            back, meta = dng.read_dng(str(path))
            if not (np.array_equal(back, mosaic) and meta["bits"] == 14
                    and meta["cfa"] == "RGGB"
                    and meta["white_level"] == SID_WHITE):
                raise AssertionError(f"{path.name}: read back differs")
            paths.append(str(path))
            nbytes += path.stat().st_size
    return shorts, longs, nbytes


def phase_ingest(tmp: Path) -> np.ndarray:
    """11b: DNG pairs written and read back bit-exact, then ingested with
    process_raw_pairs into packed records of INGEST_PATCH patches (the
    training layout), read through the port's PairRecordDataset.  The frames
    to serve are the short exposures as process_raw_pairs normalizes them,
    and every record of the first pair must equal its window of the first.
    -> the frames (N, H, W, 1) float32."""
    (tmp / "dng").mkdir()
    (shorts, longs, nbytes), write_ms = _host_ms(
        lambda: write_dng_pairs(tmp / "dng"))
    line("phase 11b dng", pairs=INGEST_PAIRS, frame=FRAME, bits=14,
         mib=f"{nbytes / 2**20:.1f}", write_and_read_s=f"{write_ms / 1e3:.2f}")
    root = tmp / "ingest"
    count, ms = _host_ms(lambda: process_raw_pairs(
        shorts, longs, str(root), ratio=INGEST_RATIO, patch=INGEST_PATCH,
        packed=True))
    data = create_dataset({"mode": "SID", "dataroot": str(root),
                           "is_train": False})
    line("phase 11b process_raw_pairs", patch=INGEST_PATCH, count=count,
         seconds=f"{ms / 1e3:.2f}",
         mb_per_s=f"{nbytes / 1e6 / (ms / 1e3):.1f}",
         out_mib=f"{sum(f.stat().st_size for f in root.iterdir()) / 2**20:.1f}")
    per_pair = (FRAME[0] // INGEST_PATCH) * (FRAME[1] // INGEST_PATCH)
    if count != INGEST_PAIRS * per_pair or len(data) != count:
        raise AssertionError(f"{count} records, want {INGEST_PAIRS * per_pair}")
    frames = np.stack([rawproc.normalize_u16(
        dng.read_dng(path)[0], SID_BLACK, SID_WHITE, INGEST_RATIO)[..., None]
        for path in shorts])
    cols = FRAME[1] // INGEST_PATCH
    for k in range(per_pair):
        y0, x0 = INGEST_PATCH * (k // cols), INGEST_PATCH * (k % cols)
        sample = data[k]
        if not (np.array_equal(sample["noisy"], frames[
                0, y0:y0 + INGEST_PATCH, x0:x0 + INGEST_PATCH])
                and sample["gt"].shape == (INGEST_PATCH, INGEST_PATCH, 3)):
            raise AssertionError(f"record {k} is not the frame at {y0}, {x0}")
    return frames


def run_artifact(path: Path, frame: Path, out: Path) -> dict:
    """An artifact loaded and served in a fresh process (_ARTIFACT_RUNNER),
    TF32 off."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", _ARTIFACT_RUNNER, str(path), str(frame),
         str(out), str(ARTIFACT_REPS)],
        cwd=str(ROOT), env=_child_env(), capture_output=True, text=True,
        timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"artifact process exited {proc.returncode}:\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
    run = json.loads(re.findall(r"^ARTIFACT (.*)$", proc.stdout, re.M)[-1])
    return {**run, "seconds": time.perf_counter() - t0}


def phase_artifacts(dev, bank, tmp: Path, frames: np.ndarray) -> dict:
    """11c: slice 2 exported with the tiled engine (PATCH, STRIDE, CHUNK) at
    1 x FRAME, f32 and bf16 storage, saved, then loaded and served on the
    first ingested frame in a fresh process; held within ARTIFACT_TOL of
    make_serving_fn on the same weights and frame in this process, with the
    same launches.  -> the artifacts' launches."""
    pipe = load_pipeline(dev, SLICE2, bank=bank)
    serve = make_serving_fn(pipe, patch=PATCH, stride=STRIDE, chunk=CHUNK,
                            device=dev)
    np.save(tmp / "frame.npy", frames[:1])
    x = torch.from_numpy(frames[:1]).to(dev)
    n_tiles = (len(tile_positions(FRAME[0], PATCH, STRIDE))
               * len(tile_positions(FRAME[1], PATCH, STRIDE)))
    calls = math.ceil(n_tiles / CHUNK)
    expected = {name: calls if name in PATHS[SLICE2] else 0
                for name in KERNELS}
    total = {name: 0 for name in KERNELS}
    for storage in ("f32", "bf16"):
        t0 = time.perf_counter()
        blob = export_pipeline(pipe, (1, *FRAME, 1), patch=PATCH,
                               stride=STRIDE, chunk=CHUNK, storage=storage)
        export_s = time.perf_counter() - t0
        path = tmp / f"slice2_{storage}.rispt"
        save_artifact(str(path), blob)
        with precision.cnn_storage(storage):
            _zero_counts()
            want = serve(x)
            torch.cuda.synchronize()
            direct = _counts()
            fn_ms = event_ms(lambda: serve(x), reps=ARTIFACT_REPS)
        want = want[0].cpu().numpy()
        run = run_artifact(path, tmp / "frame.npy", tmp / f"out_{storage}.npy")
        got = np.load(tmp / f"out_{storage}.npy")[0]
        diff = float(np.abs(got - want).max())
        line("phase 11c artifact", arch=SLICE2, storage=storage,
             shape=(1, *FRAME, 1), patch=PATCH, stride=STRIDE, chunk=CHUNK,
             mb=f"{len(blob) / 1e6:.2f}", export_s=f"{export_s:.2f}",
             max_abs_diff=f"{diff:.3e}", tol=ARTIFACT_TOL,
             launches=json.dumps(run["first_launches"]).replace(" ", ""),
             serving_fn_launches=json.dumps(direct).replace(" ", ""),
             ms_per_frame=f"{run['ms']:.3f}",
             serving_fn_ms_per_frame=f"{fn_ms:.3f}",
             peak_mib=f"{run['peak_bytes'] / 2**20:.1f}",
             process_s=f"{run['seconds']:.2f}",
             first_frame_s=f"{run['seconds_to_first_frame']:.2f}",
             imported=run["imported"], card=repr(nvidia_smi(dev.index or 0)))
        served = 1 + ARTIFACT_REPS
        if not (diff <= ARTIFACT_TOL and run["first_launches"] == direct
                == expected and not run["imported"] and run["launches"] == {
                    k: v * served for k, v in expected.items()}
                and np.isfinite(got).all() and got.shape == (*FRAME, 3)):
            raise AssertionError(f"slice 2 artifact {storage}: diff {diff}, "
                                 f"launches {run} vs {direct}")
        for name in KERNELS:
            total[name] += run["first_launches"][name]
    return total


def phase_artifacts_in_process(dev, bank, frames: np.ndarray) -> dict:
    """11d: the flagship exported whole-frame with a symbolic batch, served
    at batch 1 and 2 on the ingested frames; and slice 1 (the bilateral)
    exported whole-frame at 1 x FRAME and served in this process, its
    launches counted from 0.  Each within ARTIFACT_TOL of make_serving_fn.
    -> slice 1's artifact launches."""
    pipe = load_pipeline(dev, FLAGSHIP, bank=bank)
    t0 = time.perf_counter()
    served = load_artifact(export_pipeline(pipe, ("b", *FRAME, 1)),
                           device=dev)
    export_s = time.perf_counter() - t0
    serve = make_serving_fn(pipe, device=dev)
    for n in (1, 2):
        x = torch.from_numpy(frames[:n]).to(dev)
        got, want = served(x), serve(x)
        diff = float((got - want).abs().max())
        ms = event_ms(lambda: served(x), reps=ARTIFACT_REPS)
        line("phase 11d symbolic batch", arch=FLAGSHIP, batch=n,
             frame=FRAME, max_abs_diff=f"{diff:.3e}", tol=ARTIFACT_TOL,
             ms_per_frame=f"{ms / n:.3f}", export_and_load_s=f"{export_s:.2f}")
        if not (diff <= ARTIFACT_TOL and tuple(got.shape) == (n, *FRAME, 3)):
            raise AssertionError(f"symbolic batch {n}: {diff}")
    del served, pipe
    pipe = load_pipeline(dev, SLICE1, bank=bank)
    served = load_artifact(export_pipeline(pipe, (1, *FRAME, 1)), device=dev)
    x = torch.from_numpy(frames[:1]).to(dev)
    _zero_counts()
    got = served(x)
    torch.cuda.synchronize()
    launches = _counts()
    want = make_serving_fn(pipe, device=dev)(x)
    diff = float((got - want).abs().max())
    expected = {name: 1 if name in PATHS[SLICE1] else 0 for name in KERNELS}
    line("phase 11d artifact in process", arch=SLICE1, shape=(1, *FRAME, 1),
         max_abs_diff=f"{diff:.3e}", tol=ARTIFACT_TOL,
         launches=json.dumps(launches).replace(" ", ""))
    if not (diff <= ARTIFACT_TOL and launches == expected):
        raise AssertionError(f"slice 1 artifact: {diff}, {launches}")
    return launches


def phase_deployment(dev, bank) -> dict:
    """Phase 11: 11a rawproc, 11b DNG ingestion, 11c the slice-2 artifacts
    in fresh processes, 11d the symbolic batch and slice 1's artifact.
    -> the artifacts' launches of each kernel."""
    with tempfile.TemporaryDirectory() as root:
        tmp = Path(root)
        t0 = time.perf_counter()
        phase_rawproc()
        frames = phase_ingest(tmp)
        launches = phase_artifacts(dev, bank, tmp, frames)
        slice1 = phase_artifacts_in_process(dev, bank, frames)
        total = {name: launches[name] + slice1[name] for name in KERNELS}
        line("phase 11 launches", artifacts=json.dumps(total).replace(" ", ""),
             seconds=f"{time.perf_counter() - t0:.2f}")
    return total


# ----------------------------------------------------------------- phase 12

# Phase 12: one dispatch per search step.  On CUDA the search trainers run
# each step as a replay of one captured CUDA graph (search/darts.py,
# make_darts_multi_step), K steps a dispatch; the eager step
# (make_darts_step, the CPU path) is the reference.  Each captured run is
# held against an eager run from the same start on the same batches, within
# phase 8's SEARCH_*_TOL (phase 10's for darts_yolo); the same kernels run
# on the same inputs, and the capture-safe plain forms of the backward give
# the host-read forms' values bit for bit, so 0 is expected up to rounding
# (cuDNN's choices, atomics).  The DARTS state (momentum and Adam moments)
# is held relative to each tensor's largest value within
# DISPATCH_STATE_RTOL (printed only for darts_yolo), adam_t exactly.  Cuts: DISPATCH_STEPS steps of
# SID_search's 200,000, ORDER1_DISPATCH_STEPS of planted_search's 1,500,
# 2 + 2 of planted_search_ft's with one tuning round between, and
# YOLO_INPROC_STEPS of yolo_search's 40,000; the geometry is the configs'.
DISPATCH_STEPS = 5           # 12a: steps per run (8, then 6, until phases
                             # 14 and 15 came)
DISPATCH_TIMED_FROM = 2      # 12a: steps 3-5 timed (eager and K = 1)
DISPATCH_K = 4               # 12a: steps a dispatch of the K-step run
ORDER1_DISPATCH_STEPS = 4    # 12b
FT_DISPATCH_STEPS = 2        # 12c: steps before and after finetune_proxies
FT_DISPATCH_K = 2
# The DARTS state is sums of the step's gradients (Adam's v of their
# squares, so twice their relative error), whose relative error phase 8
# puts at about 1e-4 (the Hessian term's probes difference two passes of
# the same rounding); DISPATCH_STATE_RTOL leaves 10x over that estimate,
# 5x over v's, as phase 8's tolerances leave 10-100x over theirs.  The
# alphas and theta the state moves are held at SEARCH_*_TOL.
DISPATCH_STATE_RTOL = 1e-3


def _planted_pairs(dev, opt, count: int, seed: int) -> list:
    """`count` (train, val) pairs of planted crops at the options'
    geometry, made on the card from `seed`."""
    data = opt["datasets"]["train"]
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [(make_planted_batch(dev, data["batch_size"], data["data_size"],
                                gen),
             make_planted_batch(dev, data["batch_size"], data["data_size"],
                                gen)) for _ in range(count)]


def _with_dispatch(opt, k: int):
    """The options with train.steps_per_dispatch = k."""
    return {**opt, "train": {**opt["train"], "steps_per_dispatch": k}}


def _eager_steps(trainer, pairs, *, record=False, timed_from=None) -> dict:
    """The trainer's step function (make_darts_step) called eagerly on each
    pair, as search_step schedules it, with no graph; the trainer's state
    advances.  -> {"logs", "launches", "ms"} with every count set to 0 just
    before and read just after, steps from `timed_from` on timed."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    _zero_counts()
    logs = []
    for i, (tb, vb) in enumerate(pairs):
        if i == timed_from:
            start.record()
        trainer.step_idx += 1
        batch = {k: trainer._tensor(v)
                 for k, v in trainer.step_batch(tb, vb).items()}
        trainer.variables, trainer.opt_state, out = trainer._step(
            trainer.variables, trainer.opt_state, batch,
            trainer.schedule(trainer.step_idx))
        trainer._last_aux = {k: out.pop(k) for k in list(out)
                             if k.startswith("_")}
        logs.append({k: float(v) for k, v in out.items()})
        if record:
            trainer.record_intermediates()
    end.record()
    torch.cuda.synchronize()
    ms = (start.elapsed_time(end) / (len(pairs) - timed_from)
          if timed_from is not None else None)
    return {"logs": logs, "launches": _counts(), "ms": ms}


def _captured_steps(trainer, pairs, *, record=False, timed_from=None
                    ) -> dict:
    """search_step on each pair (on the card a replay of the step's graph,
    K a dispatch), then a flush; as _eager_steps, and the first
    dispatch's wall seconds (warm-up, capture and its replays)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    _zero_counts()
    logs, first_s = [], None
    for i, (tb, vb) in enumerate(pairs):
        if i == timed_from:
            start.record()
        t0 = time.perf_counter()
        logs.append(trainer.search_step(tb, vb))
        if first_s is None and trainer.graph is not None:
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
        if record:
            trainer.record_intermediates()
    trainer.flush()
    end.record()
    torch.cuda.synchronize()
    ms = (start.elapsed_time(end) / (len(pairs) - timed_from)
          if timed_from is not None else None)
    return {"logs": logs, "launches": _counts(), "ms": ms,
            "first_dispatch_s": first_s}


def _state_diff(a, b) -> tuple:
    """(alphas, theta, DARTS state relative to its largest value, adam_t)
    differences of two trainers."""
    state = 0.0
    for key in ("momentum", "adam_m", "adam_v"):
        for x, y in zip(_leaves(a.opt_state[key]),
                        _leaves(b.opt_state[key])):
            scale = max(float(y.abs().max()), 1e-30)
            state = max(state, float((x - y).abs().max()) / scale)
    return (_max_diff(a.variables["alphas"], b.variables["alphas"]),
            _max_diff(a.variables["theta"], b.variables["theta"]), state,
            int(a.opt_state["adam_t"]) - int(b.opt_state["adam_t"]))


def _hold_dispatch(what: str, got, ref, got_logs: list, ref_logs: list,
                   loss_rtol=SEARCH_LOSS_RTOL, alpha_tol=SEARCH_ALPHA_TOL,
                   theta_tol=SEARCH_THETA_TOL,
                   state_rtol=DISPATCH_STATE_RTOL,
                   phase="phase 12 captured vs eager") -> None:
    """Raise unless trainer `got` is trainer `ref` within the tolerances,
    each of got_logs against the ref_logs step it pairs with; the DARTS
    state is printed, and held unless state_rtol is None."""
    loss_diff = max(abs(a[k] - b[k]) / abs(b[k])
                    for a, b in zip(got_logs, ref_logs)
                    for k in ("loss", "val_loss"))
    alpha, theta, state, adam_t = _state_diff(got, ref)
    line(phase, run=what,
         max_loss_rel_diff=f"{loss_diff:.3e}", loss_rtol=loss_rtol,
         max_alpha_diff=f"{alpha:.3e}", alpha_tol=alpha_tol,
         max_theta_diff=f"{theta:.3e}", theta_tol=f"{theta_tol:.3e}",
         max_state_rel_diff=f"{state:.3e}", state_rtol=state_rtol,
         adam_t_diff=adam_t)
    if not (loss_diff <= loss_rtol and alpha <= alpha_tol
            and theta <= theta_tol and adam_t == 0
            and (state_rtol is None or state <= state_rtol)):
        raise AssertionError(f"{what}: the runs part")


def _profile_step(run) -> dict:
    """run() once under torch.profiler -> its wall ms, the device's busy
    ms (the union of the kernels' spans) and the kernels and copies it
    launched.  The profiler's raw events are read, not its event tree,
    whose build takes tens of seconds at a replay's 10^5 kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, kernels = [], 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA \
                or e.is_user_annotation():
            continue
        spans.append((e.start_ns(), e.end_ns()))
        kernels += not any(w in e.name().lower()
                           for w in ("memcpy", "memset"))
    if not spans:
        raise AssertionError("the profiler recorded no device time")
    busy_ns, reach = 0, None
    for start, stop in sorted(spans):
        if reach is None or start > reach:
            busy_ns, reach = busy_ns + stop - start, stop
        elif stop > reach:
            busy_ns, reach = busy_ns + stop - reach, stop
    return {"wall_ms": wall_ms, "busy_ms": busy_ns / 1e6,
            "kernels": kernels, "copies": len(spans) - kernels}


def _replay_tally_ok(launches: dict) -> bool:
    """A captured SID_search step's tally: 15 launches of each forward
    kernel, the bilateral's backward kernel 3 an application and fast
    NLM's a multiple of 15 (its launch groups)."""
    forward = {name: n for name, n in launches.items() if name in KERNELS}
    return (forward == {name: 15 for name in KERNELS}
            and launches["bilateral.backward"] == 15 * 3
            and launches["fastnlm.backward"] % 15 == 0)


def phase_dispatch_sid(dev, bank) -> dict:
    """12a: SID_search order 2, DISPATCH_STEPS steps eager, captured at
    K = 1 and at K = DISPATCH_K, from one start on the same planted
    batches; ms a step, the busy share and kernels of a captured step, the
    capture's seconds and pool.  -> the replays' launches, and K = 1's ms
    a step."""
    opt = search_options(SID_SEARCH)
    pairs = _planted_pairs(dev, opt, DISPATCH_STEPS, seed=12)
    eager = make_search_trainer(dev, bank, opt)
    ref = _eager_steps(eager, pairs, timed_from=DISPATCH_TIMED_FROM)
    expected = {name: 15 * DISPATCH_STEPS for name in KERNELS}
    if ref["launches"] != expected:
        raise AssertionError(f"eager launches {ref['launches']}")
    runs = {}
    for k in (1, DISPATCH_K):
        trainer = make_search_trainer(dev, bank, _with_dispatch(opt, k))
        run = _captured_steps(trainer, pairs, timed_from=(
            DISPATCH_TIMED_FROM if k == 1 else k))
        graph = trainer.graph
        line("phase 12a SID_search", run=f"captured_k{k}", order=2,
             batch=tuple(pairs[0][0]["noisy"].shape), steps=DISPATCH_STEPS,
             ms_per_step=f"{run['ms']:.3f}",
             eager_ms_per_step=f"{ref['ms']:.3f}",
             first_dispatch_s=f"{run['first_dispatch_s']:.2f}",
             capture_s=f"{graph.capture_s:.2f}",
             capture_record_s=f"{graph.record_s:.2f}",
             pool_mib=f"{graph.pool_bytes / 2**20:.1f}",
             launches=json.dumps(run["launches"]).replace(" ", ""),
             replay_launches=json.dumps(graph.launches).replace(" ", ""),
             warmup_launches=json.dumps(graph.warmup_launches)
             .replace(" ", ""))
        if run["launches"] != expected or not _replay_tally_ok(
                graph.launches):
            raise AssertionError(f"captured K={k}: launches {run['launches']}"
                                 f", a replay {graph.launches}")
        # K = 1 logs every step; K = 4 returns step 4's logs at step 4 and
        # step 5's after the flush
        if k == 1:
            got_logs, ref_logs = run["logs"], ref["logs"]
        else:
            got_logs = [run["logs"][k - 1], trainer.last_logs]
            ref_logs = [ref["logs"][k - 1], ref["logs"][-1]]
        _hold_dispatch(f"SID_search order 2 K={k}", trainer, eager, got_logs,
                       ref_logs)
        runs[k] = (trainer, run)
    _hold_dispatch(f"SID_search K={DISPATCH_K} vs K=1", runs[DISPATCH_K][0],
                   runs[1][0], [runs[DISPATCH_K][0].last_logs],
                   [runs[1][0].last_logs])

    trainer = runs[1][0]
    tb, vb = pairs[0]
    t0 = time.perf_counter()
    prof = _profile_step(lambda: trainer.search_step(tb, vb))
    line("phase 12a captured step profile", run="captured_k1",
         profile_s=f"{time.perf_counter() - t0:.1f}",
         wall_ms=f"{prof['wall_ms']:.3f}", busy_ms=f"{prof['busy_ms']:.3f}",
         busy_share=f"{prof['busy_ms'] / prof['wall_ms']:.4f}",
         kernels_per_replay=prof["kernels"], copies=prof["copies"],
         nvidia_smi=repr(nvidia_smi(dev.index or 0)))
    return ({name: sum(r["launches"][name] for _, r in runs.values())
             for name in KERNELS}, runs[1][1]["ms"])


def phase_dispatch_order1(dev, bank) -> dict:
    """12b: first order at planted_search.yaml's rates, captured against
    eager.  -> the replays' launches."""
    opt = search_options(PLANTED_SEARCH)
    pairs = _planted_pairs(dev, opt, ORDER1_DISPATCH_STEPS, seed=13)
    eager = make_search_trainer(dev, bank, opt, order=1)
    ref = _eager_steps(eager, pairs)
    trainer = make_search_trainer(dev, bank, opt, order=1)
    run = _captured_steps(trainer, pairs)
    line("phase 12b planted_search", run="captured_k1", order=1,
         steps=ORDER1_DISPATCH_STEPS,
         capture_s=f"{trainer.graph.capture_s:.2f}",
         pool_mib=f"{trainer.graph.pool_bytes / 2**20:.1f}",
         launches=json.dumps(run["launches"]).replace(" ", ""))
    if run["launches"] != ref["launches"]:
        raise AssertionError(f"order 1: launches {run['launches']} != "
                             f"{ref['launches']}")
    _hold_dispatch("planted_search order 1", trainer, eager, run["logs"],
                   ref["logs"])
    return run["launches"]


def _shadow(dev, bank, opt, trainer, omega=None):
    """A DartsFtTrainer for eager steps that holds `trainer`'s variables,
    DARTS state and step (omega's values from `omega` if given)."""
    shadow = make_search_trainer(dev, bank, opt, ft=True)
    variables = dict(trainer.variables)
    if omega is not None:
        variables["omega"] = omega
    shadow._assign(variables, trainer.opt_state)
    shadow.step_idx = trainer.step_idx
    return shadow


def phase_dispatch_ft(dev, bank) -> dict:
    """12c: DartsFtTrainer at planted_search_ft.yaml, captured at K = 1 and
    K = FT_DISPATCH_K: FT_DISPATCH_STEPS steps, each recorded, against
    eager steps (the replay memories equal), one finetune_proxies, then
    FT_DISPATCH_STEPS more against eager steps from the trainer's own state
    after the tuning: the replays read the tuned proxies, and an eager run
    from the same state with the untuned ones parts from them by far more
    than the tolerance.  (The tuning's Adam moves a weight whose gradient
    is near its eps by up to lr a step on rounding alone, so runs are
    compared from one state after it, not across it.)  -> the replays'
    launches."""
    opt = search_options(PLANTED_SEARCH_FT)
    pairs = _planted_pairs(dev, opt, 2 * FT_DISPATCH_STEPS, seed=14)
    first, second = pairs[:FT_DISPATCH_STEPS], pairs[FT_DISPATCH_STEPS:]
    eager = make_search_trainer(dev, bank, opt, ft=True)
    ref = _eager_steps(eager, first, record=True)
    total = {name: 0 for name in KERNELS}
    for k in (1, FT_DISPATCH_K):
        trainer = make_search_trainer(dev, bank, _with_dispatch(opt, k),
                                      ft=True)
        run = _captured_steps(trainer, first, record=True)
        memory = max(float((a - b).abs().max())
                     for a, b in zip(trainer.ft_data, eager.ft_data))
        got_logs, ref_logs = run["logs"][k - 1::k], ref["logs"][k - 1::k]
        _hold_dispatch(f"planted_search_ft K={k} before tuning", trainer,
                       eager, got_logs, ref_logs)
        untuned = {name: copy.deepcopy(m)
                   for name, m in trainer.variables["omega"].items()}
        ft = trainer.finetune_proxies()
        tuned_ref = _shadow(dev, bank, opt, trainer)
        untuned_ref = _shadow(dev, bank, opt, trainer, omega=untuned)
        want = _eager_steps(tuned_ref, second, record=True)
        stale = _eager_steps(untuned_ref, second)
        after = _captured_steps(trainer, second, record=True)
        moved = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                    for a, b in zip(stale["logs"], want["logs"]))
        n_new = len(tuned_ref.ft_data)
        memory_after = max(float((a - b).abs().max()) for a, b in zip(
            trainer.ft_data[-n_new:], tuned_ref.ft_data))
        line("phase 12c planted_search_ft", run=f"captured_k{k}",
             steps=2 * FT_DISPATCH_STEPS, memory=len(trainer.ft_data),
             eager_memory=len(eager.ft_data),
             max_memory_diff=f"{memory:.3e}",
             max_memory_diff_after_tuning=f"{memory_after:.3e}",
             memory_tol=SEARCH_ALPHA_TOL,
             untuned_loss_rel_move=f"{moved:.3e}",
             ft_losses=json.dumps({k_: round(v, 8) for k_, v in ft.items()})
             .replace(" ", ""))
        if len(eager.ft_data) != len(trainer.ft_data) - n_new \
                or memory > SEARCH_ALPHA_TOL \
                or memory_after > SEARCH_ALPHA_TOL:
            raise AssertionError(f"ft K={k}: the replay memory parts")
        if not moved > 10 * SEARCH_LOSS_RTOL:
            raise AssertionError(f"the tuning moved the loss by {moved:.3e}")
        _hold_dispatch(f"planted_search_ft K={k} after tuning", trainer,
                       tuned_ref, after["logs"][k - 1::k],
                       want["logs"][k - 1::k])
        for name in KERNELS:
            total[name] += run["launches"][name] + after["launches"][name]
    return total


def phase_dispatch_yolo(dev, bank) -> dict:
    """12d: darts_yolo at yolo_search.yaml's geometry under phase 10's
    detector: YOLO_INPROC_STEPS captured steps against eager, at phase 10's
    tolerances (losses, alphas, theta relative to its move).  The seeded
    detector's loss is almost flat, so the DARTS state's moments are
    rounding-sized in places and are printed, not held.  -> the replays'
    launches."""
    with tempfile.TemporaryDirectory() as root:
        tmp = Path(root)
        _, weights = write_yolo_weights(tmp)
        opt = config.parse_dict(_yolo_options(
            YOLO_SEARCH, tmp, weights, {"n": 2 * YOLO_FRAMES}),
            root=str(tmp))
        n = opt["datasets"]["train"]["batch_size"]
        size = opt["datasets"]["train"]["data_size"]
        pairs = [(_yolo_batch(opt, 2 * i * n, n, dev),
                  _yolo_batch(opt, (2 * i + 1) * n, n, dev))
                 for i in range(YOLO_INPROC_STEPS)]
        criterion = make_yolo_criterion(build_yolo_evaluator(opt["yolo"], dev),
                                        size)
        kw = {"criterion": criterion, "target_key": "label"}
        eager = make_search_trainer(dev, bank, opt, **kw)
        ref = _eager_steps(eager, pairs, timed_from=1)
        trainer = make_search_trainer(dev, bank, opt, **kw)
        run = _captured_steps(trainer, pairs, timed_from=1)
        start = make_search_trainer(dev, bank, opt, **kw).variables
    theta_move = _max_diff(eager.variables["theta"], start["theta"])
    line("phase 12d darts_yolo", run="captured_k1",
         batch=tuple(pairs[0][0]["noisy"].shape), steps=YOLO_INPROC_STEPS,
         ms_per_step=f"{run['ms']:.3f}", eager_ms_per_step=f"{ref['ms']:.3f}",
         capture_s=f"{trainer.graph.capture_s:.2f}",
         pool_mib=f"{trainer.graph.pool_bytes / 2**20:.1f}",
         launches=json.dumps(run["launches"]).replace(" ", ""))
    expected = {name: 15 * YOLO_INPROC_STEPS for name in KERNELS}
    if run["launches"] != expected or ref["launches"] != expected:
        raise AssertionError(f"darts_yolo: launches {run['launches']}, "
                             f"eager {ref['launches']}")
    _hold_dispatch("darts_yolo", trainer, eager, run["logs"], ref["logs"],
                   loss_rtol=YOLO_LOSS_RTOL, alpha_tol=YOLO_ALPHA_TOL,
                   theta_tol=YOLO_THETA_RTOL * theta_move, state_rtol=None)
    return run["launches"]


def phase_dispatch(dev, bank):
    """Phase 12: 12a-12d.  -> each kernel's launches through replays, and
    12a's ms a captured step at K = 1."""
    parts, seconds = [], []
    for part in (phase_dispatch_sid, phase_dispatch_order1, phase_dispatch_ft,
                 phase_dispatch_yolo):
        t0 = time.perf_counter()
        parts.append(part(dev, bank))
        seconds.append(f"{time.perf_counter() - t0:.1f}")
    parts[0], sid_ms = parts[0]
    total = {name: sum(p[name] for p in parts) for name in KERNELS}
    line("phase 12 launches", replays=json.dumps(total).replace(" ", ""),
         seconds="/".join(seconds))
    return total, sid_ms


# ----------------------------------------------------------------- phase 13

# Phase 13: data parallelism over a process group (parallel/mesh.py,
# parallel/dp.py): every rank takes its rows of the global batch, its
# criterion returns its share of the global loss and the gradients are
# SUM-reduced, so each run is held against the serial one on the same global
# batches.  The card is one, and NCCL puts no two ranks on one device: two
# ranks share cuda:0 over gloo (13a, b, d, e, f; their steps run eagerly,
# as gloo's collectives cannot be captured), so their times measure
# correctness and overhead, not scaling; one NCCL rank (13c) runs the
# captured step with its all-reduces inside the graph.  Tolerances:
# phase 8's SEARCH_*_TOL for SID_search (the ranks sum the same terms in
# another order: rounding, far inside them), DISPATCH_STATE_RTOL for the
# DARTS state of 13c, phase 7's TRAIN_* for IspTrainer, phase 10's YOLO_*
# for darts_yolo, ARTIFACT_TOL for the served artifact.  Cuts (steps, never
# geometry): DP_SEARCH_STEPS of SID_search's 200,000 (13b, and 13c at K =
# 1 and 2, both held to 13b's serial captured run), DP_ISP_STEPS of
# SID_isp's 80,000, DP_YOLO_STEPS of yolo_search's 40,000; 13e runs
# SEARCH_CLI_STEPS through torchrun against 9c's serial CLI run of the same
# records and options.
DP_WORLD = 2
DP_SEARCH_STEPS = 3
DP_ISP_STEPS = 3
DP_YOLO_STEPS = 2


def _rank_device() -> torch.device:
    """This rank's card, made current by parallel/mesh.init_process_group."""
    return torch.device("cuda", torch.cuda.current_device())


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, dev) for v in tree)
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


def _state_out(trainer) -> dict:
    """A search trainer's alphas, theta and DARTS state on the host, as
    _hold_dispatch reads them."""
    return {"variables": {key: _to(trainer.variables[key], "cpu")
                          for key in ("alphas", "theta")},
            "opt_state": _to(trainer.opt_state, "cpu")}


def _dp_rank(rank: int, root: str) -> None:
    """One of DP_WORLD gloo ranks on the card: 13b SID_search, 13d SID_isp
    (slice 2) and yolo_search, 13f the data-parallel artifact, each on the
    global batches that <root>/dp13.pt holds; results to
    <root>/dp_rank<r>.pt."""
    tf32_off()
    dev = _rank_device()
    tmp = Path(root)
    inputs = torch.load(tmp / "dp13.pt", weights_only=False)
    bank = load_network(str(BANK))
    out = {}

    opt = search_options(SID_SEARCH)
    mesh = dist_mesh(opt["datasets"]["train"]["batch_size"])
    trainer = make_search_trainer(dev, bank, opt, mesh=mesh)
    run = _captured_steps(trainer, _to(inputs["search"], dev), timed_from=1)
    out["search"] = {"logs": run["logs"], "launches": run["launches"],
                     "ms": run["ms"], "eager": trainer.graph is None,
                     "mesh": tuple(mesh.shape), "state": _state_out(trainer)}

    _, use_proxy, train_opt, _, _ = sid_isp_options()
    trainer = make_trainer(dev, SLICE2, use_proxy, bank, train_opt, mesh=mesh)
    run = _train_run(trainer, _to(inputs["isp"], dev), DP_ISP_STEPS, 1)
    out["isp"] = {k: run[k] for k in ("losses", "logits", "launches", "ms")}

    yopt = inputs["yolo_opt"]
    criterion = make_yolo_criterion(
        build_yolo_evaluator(yopt["yolo"], dev),
        yopt["datasets"]["train"]["data_size"])
    trainer = make_search_trainer(dev, bank, yopt, criterion=criterion,
                                  target_key="label", mesh=mesh)
    run = _captured_steps(trainer, _to(inputs["yolo"], dev), timed_from=1)
    out["yolo"] = {"logs": run["logs"], "launches": run["launches"],
                   "ms": run["ms"], "state": _state_out(trainer)}

    served = load_artifact(str(tmp / "dp2.rispt"), device=dev)
    frames = torch.from_numpy(np.load(tmp / "frames.npy")).to(dev)
    _zero_counts()
    t0 = time.perf_counter()
    y = served(frames)
    torch.cuda.synchronize()
    want = torch.from_numpy(np.load(tmp / "served.npy")).to(dev)
    out["artifact"] = {"diff": float((y - want).abs().max()),
                       "shape": tuple(y.shape), "launches": _counts(),
                       "s": time.perf_counter() - t0}
    del served, frames, want, y
    torch.cuda.empty_cache()
    out["space"] = _space_rank(dev, tmp, inputs, bank)
    torch.save(out, tmp / f"dp_rank{rank}.pt")


def _dp_nccl_rank(rank: int, root: str) -> None:
    """13c, one NCCL rank: SID_search's captured step with make_mesh(1)
    passed explicitly, so the step's all-reduces run inside the graph, at
    K = 1 and K = 2 against 13b's serial captured run without a mesh (its
    logs, variables and DARTS state)."""
    tf32_off()
    dev = _rank_device()
    tmp = Path(root)
    inputs = torch.load(tmp / "dp13c.pt", weights_only=False)
    pairs = _to(inputs["pairs"], dev)
    ref = types.SimpleNamespace(**_to(inputs["state"], dev))
    bank = load_network(str(BANK))
    opt = search_options(SID_SEARCH)
    backend = torch.distributed.get_backend()
    if backend != "nccl":
        raise AssertionError(f"13c runs over NCCL, not {backend}")
    mesh = meshlib.make_mesh(1)
    out = {"runs": {}}
    for k in (1, 2):
        trainer = make_search_trainer(dev, bank, _with_dispatch(opt, k),
                                      mesh=mesh)
        run = _captured_steps(trainer, pairs, timed_from=k)
        _hold_dispatch(f"SID_search, NCCL mesh (1, 1), K={k}", trainer, ref,
                       run["logs"][k - 1::k], inputs["logs"][k - 1::k],
                       phase="phase 13c NCCL mesh vs no mesh")
        graph = trainer.graph
        out["runs"][k] = {"ms": run["ms"], "launches": run["launches"],
                          "replay_launches": graph.launches,
                          "capture_s": graph.capture_s}
    torch.save(out, tmp / "dp_nccl.pt")


def phase_dp_dryrun() -> dict:
    """13a: dryrun_multichip over DP_WORLD gloo ranks on the card; the
    native step's bilateral launches 5 times on each rank (one a pass).
    -> the ranks' launches."""
    t0 = time.perf_counter()
    out = dryrun_multichip(DP_WORLD, "cuda")
    ranks = [r[-1] for r in out["launches"]]
    line("phase 13a dryrun_multichip", world=DP_WORLD, backend="gloo",
         mesh=json.dumps(out["mesh"]).replace(" ", ""),
         checks=" | ".join(out["lines"]).replace(" ", "_"),
         rank_launches=json.dumps(ranks).replace(" ", ""),
         seconds=f"{time.perf_counter() - t0:.1f}")
    want = {"bilateral": 5, "median": 0, "fastnlm": 0}
    if any(r != want for r in ranks):
        raise AssertionError(f"dry run launches {ranks}")
    return {name: sum(r[name] for r in ranks) for name in KERNELS}


def _dp_inputs(dev, bank, tmp: Path) -> dict:
    """The global batches of 13b, 13c, 13d and 13f, their serial runs
    here, and the files the ranks read."""
    opt = search_options(SID_SEARCH)
    if not opt.get("dist"):
        raise AssertionError("configs/SID_search.yaml is dist: true")
    pairs = _planted_pairs(dev, opt, DP_SEARCH_STEPS, seed=0)
    serial = make_search_trainer(dev, bank, opt)
    search = _captured_steps(serial, pairs, timed_from=1)
    search["state"] = _state_out(serial)

    arch, use_proxy, train_opt, n, size = sid_isp_options()
    batch = make_training_batch(dev, n, size)
    isp = _train_run(make_trainer(dev, SLICE2, use_proxy, bank, train_opt),
                     batch, DP_ISP_STEPS, 1)

    _, weights = write_yolo_weights(tmp)
    yopt = config.parse_dict(_yolo_options(
        YOLO_SEARCH, tmp, weights, {"n": 2 * YOLO_FRAMES}), root=str(tmp))
    yn = yopt["datasets"]["train"]["batch_size"]
    ypairs = [(_yolo_batch(yopt, 2 * i * yn, yn, dev),
               _yolo_batch(yopt, (2 * i + 1) * yn, yn, dev))
              for i in range(DP_YOLO_STEPS)]
    kw = {"criterion": make_yolo_criterion(
        build_yolo_evaluator(yopt["yolo"], dev),
        yopt["datasets"]["train"]["data_size"]), "target_key": "label"}
    ytrainer = make_search_trainer(dev, bank, yopt, **kw)
    yolo = _eager_steps(ytrainer, ypairs, timed_from=1)
    yolo["state"] = _state_out(ytrainer)
    yolo["theta_move"] = _max_diff(
        ytrainer.variables["theta"],
        make_search_trainer(dev, bank, yopt, **kw).variables["theta"])

    pipe = load_pipeline(dev, FLAGSHIP, bank=bank)
    frames = make_frames(dev)
    save_artifact(str(tmp / "dp2.rispt"), export_pipeline(
        pipe, tuple(frames.shape), data_parallel=DP_WORLD))
    np.save(tmp / "frames.npy", frames.cpu().numpy())
    np.save(tmp / "served.npy", make_serving_fn(pipe, device=dev)(
        frames).cpu().numpy())
    t0 = time.perf_counter()
    slice2 = load_pipeline(dev, SLICE2, bank=bank)
    blob = export_pipeline(slice2, (1, *FRAME, 1), data_parallel=1,
                           space_parallel=SPACE_WORLD)
    save_artifact(str(tmp / "space2.rispt"), blob)
    export_s = time.perf_counter() - t0
    del slice2

    torch.save({"search": _to(pairs, "cpu"),
                "isp": _to(batch, "cpu"), "yolo": _to(ypairs, "cpu"),
                "yolo_opt": yopt}, tmp / "dp13.pt")
    torch.save({"pairs": _to(pairs, "cpu"), "logs": search["logs"],
                "state": search["state"]}, tmp / "dp13c.pt")
    del pipe, frames, serial, ytrainer
    torch.cuda.empty_cache()
    return {"search": search, "isp": isp, "yolo": yolo,
            "batch": tuple(pairs[0][0]["noisy"].shape),
            "yolo_batch": tuple(ypairs[0][0]["noisy"].shape),
            "space_export": {"s": export_s, "mb": len(blob) / 1e6}}


def phase_dp_ranks(dev, bank, tmp: Path) -> tuple:
    """13b, 13d, 13f over DP_WORLD gloo ranks, each held against its serial
    run.  -> the ranks' launches, and 13b's serial ms a step."""
    t0 = time.perf_counter()
    ref = _dp_inputs(dev, bank, tmp)
    prep_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    launch.spawn(_dp_rank, DP_WORLD, device="cuda",
                 init_file=str(tmp / "dp_store"), args=(str(tmp),))
    ranks = [torch.load(tmp / f"dp_rank{r}.pt", weights_only=False)
             for r in range(DP_WORLD)]
    ranks_s = time.perf_counter() - t0
    total = {name: 0 for name in KERNELS}
    for r, got in enumerate(ranks):
        search, isp, yolo, art = (got[k] for k in ("search", "isp", "yolo",
                                                   "artifact"))
        line("phase 13b SID_search", rank=r, world=DP_WORLD, backend="gloo",
             mesh=search["mesh"], eager=search["eager"],
             batch=ref["batch"], steps=DP_SEARCH_STEPS,
             ms_per_step=f"{search['ms']:.3f}",
             serial_captured_ms_per_step=f"{ref['search']['ms']:.3f}",
             launches=json.dumps(search["launches"]).replace(" ", ""))
        _hold_dispatch(f"13b SID_search rank {r}",
                       types.SimpleNamespace(**search["state"]),
                       types.SimpleNamespace(**ref["search"]["state"]),
                       search["logs"], ref["search"]["logs"],
                       phase="phase 13 ranks vs serial")
        if not search["eager"] or search["launches"] != {
                name: 15 * DP_SEARCH_STEPS for name in KERNELS}:
            raise AssertionError(f"13b rank {r}: {search['launches']}")

        loss = max(abs(a - b) / abs(b) for a, b in zip(
            isp["losses"], ref["isp"]["losses"]))
        logit = max(float(np.abs(isp["logits"][k] - v).max())
                    for k, v in ref["isp"]["logits"].items())
        line("phase 13d SID_isp", rank=r, arch=SLICE2, steps=DP_ISP_STEPS,
             ms_per_step=f"{isp['ms']:.3f}",
             serial_ms_per_step=f"{ref['isp']['ms']:.3f}",
             max_loss_rel_diff=f"{loss:.3e}", loss_rtol=TRAIN_LOSS_RTOL,
             max_logit_diff=f"{logit:.3e}", logit_tol=TRAIN_LOGIT_TOL,
             launches=json.dumps(isp["launches"]).replace(" ", ""))
        if not (loss <= TRAIN_LOSS_RTOL and logit <= TRAIN_LOGIT_TOL) \
                or isp["launches"] != {"bilateral": 0, "median": DP_ISP_STEPS,
                                       "fastnlm": DP_ISP_STEPS}:
            raise AssertionError(f"13d SID_isp rank {r}")

        line("phase 13d yolo_search", rank=r, batch=ref["yolo_batch"],
             steps=DP_YOLO_STEPS, ms_per_step=f"{yolo['ms']:.3f}",
             serial_eager_ms_per_step=f"{ref['yolo']['ms']:.3f}",
             launches=json.dumps(yolo["launches"]).replace(" ", ""))
        _hold_dispatch(f"13d darts_yolo rank {r}",
                       types.SimpleNamespace(**yolo["state"]),
                       types.SimpleNamespace(**ref["yolo"]["state"]),
                       yolo["logs"], ref["yolo"]["logs"],
                       loss_rtol=YOLO_LOSS_RTOL, alpha_tol=YOLO_ALPHA_TOL,
                       theta_tol=YOLO_THETA_RTOL * ref["yolo"]["theta_move"],
                       state_rtol=None, phase="phase 13 ranks vs serial")
        if yolo["launches"] != {name: 15 * DP_YOLO_STEPS for name in KERNELS}:
            raise AssertionError(f"13d darts_yolo rank {r}")

        line("phase 13f data-parallel artifact", rank=r, arch=FLAGSHIP,
             data_parallel=DP_WORLD, out=art["shape"],
             max_abs_diff=f"{art['diff']:.3e}", tol=ARTIFACT_TOL,
             first_call_s=f"{art['s']:.2f}")
        if not (art["diff"] <= ARTIFACT_TOL
                and art["shape"] == (DP_WORLD, *FRAME, 3)):
            raise AssertionError(f"13f rank {r}: {art}")
        for name in KERNELS:
            total[name] += (search["launches"][name] + isp["launches"][name]
                            + yolo["launches"][name]
                            + art["launches"][name])
    line("phase 13 ranks", world=DP_WORLD, serial_runs_s=f"{prep_s:.1f}",
         ranks_s=f"{ranks_s:.1f}")
    return total, ref["search"]["ms"], (ranks, ref)


def phase_dp_nccl(tmp: Path, serial_ms: float, phase12_ms: float) -> dict:
    """13c: one NCCL rank, the captured step with live reductions, after
    phase_dp_ranks wrote 13b's serial run.  -> its launches."""
    t0 = time.perf_counter()
    launch.spawn(_dp_nccl_rank, 1, device="cuda",
                 init_file=str(tmp / "nccl_store"), args=(str(tmp),))
    got = torch.load(tmp / "dp_nccl.pt", weights_only=False)
    total = {name: 0 for name in KERNELS}
    for k, run in got["runs"].items():
        line("phase 13c SID_search", backend="nccl", mesh=(1, 1), k=k,
             steps=DP_SEARCH_STEPS, ms_per_step=f"{run['ms']:.3f}",
             no_mesh_ms_per_step=f"{serial_ms:.3f}",
             phase12_k1_ms_per_step=f"{phase12_ms:.3f}",
             capture_s=f"{run['capture_s']:.2f}",
             launches=json.dumps(run["launches"]).replace(" ", ""))
        if run["launches"] != {name: 15 * DP_SEARCH_STEPS for name in KERNELS} \
                or not _replay_tally_ok(run["replay_launches"]):
            raise AssertionError(f"13c K={k}: {run['launches']}")
        for name in KERNELS:
            total[name] += run["launches"][name]
    line("phase 13c", seconds=f"{time.perf_counter() - t0:.1f}")
    return total


def phase_dp_cli(tmp: Path) -> dict:
    """13e: python -m torch.distributed.run --standalone --nproc-per-node
    DP_WORLD over the train CLI, SID_search.yaml as written (dist: true) on
    phase 9's records, SEARCH_CLI_STEPS steps, against 9c's serial CLI run
    of the same options; rank 0 alone saves the checkpoint.  -> the
    ranks' launches."""
    opt = yaml.safe_load(SID_SEARCH.read_text())
    opt["datasets"]["train"].update(mode="SID_Records",
                                    dataroot=str(tmp / "records"))
    opt["train"]["niter"] = SEARCH_CLI_STEPS
    opt["path"] = {"root": str(tmp / "dp"), "pretrain_proxies": str(BANK)}
    runner = tmp / "cli_runner.py"
    runner.write_text(_CLI_RUNNER)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(DP_WORLD), str(runner), "",
         "reconfigisp_tpu_torch.train", "--opt",
         _write_options(tmp / "search_dp.yaml", opt)],
        cwd=str(ROOT), env=_child_env(), capture_output=True, text=True,
        timeout=600)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"torchrun exited {proc.returncode}:\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
    ranks = sorted((json.loads(c) for c in re.findall(
        r"^CLI_COUNTS (.*)$", proc.stdout, re.M)), key=lambda c: c["rank"])
    summary = _summary(proc.stdout)
    rel = Path("experiments") / "SID_search" / "models" / \
        f"{SEARCH_CLI_STEPS}_G.ckpt"
    got, want = (load_network(str(root / rel)) for root in (tmp / "dp", tmp))
    alpha = max(float(np.abs(got["alphas"][k] - v).max())
                for k, v in want["alphas"].items())
    theta = max(float(np.abs(got["theta"][s][o] - v).max())
                for s, ops in want["theta"].items() for o, v in ops.items())
    saves = [[Path(p).name for p in c["saves"]] for c in ranks]
    line("phase 13e torchrun train.py", world=DP_WORLD,
         config="SID_search.yaml", steps=summary["steps"],
         loss=f"{summary['loss']:.6f}",
         steady_s_per_iter=summary.get("steady_s_per_iter"),
         max_alpha_diff=f"{alpha:.3e}", alpha_tol=SEARCH_ALPHA_TOL,
         max_theta_diff=f"{theta:.3e}", theta_tol=SEARCH_THETA_TOL,
         saves=json.dumps(saves).replace(" ", ""),
         summaries=proc.stdout.count("training done:"),
         launches=json.dumps([c["launches"] for c in ranks]).replace(" ", ""),
         process_s=f"{seconds:.2f}")
    expected = {name: 15 * SEARCH_CLI_STEPS for name in KERNELS}
    if not (alpha <= SEARCH_ALPHA_TOL and theta <= SEARCH_THETA_TOL
            and [c["rank"] for c in ranks] == ["0", "1"]
            and saves == [[rel.name], []]
            and proc.stdout.count("training done:") == 1
            and all(c["launches"] == expected for c in ranks)):
        raise AssertionError("13e: the torchrun run parts from the serial "
                             "CLI run")
    return {name: sum(c["launches"][name] for c in ranks) for name in KERNELS}


def phase_data_parallel(dev, bank, tmp: Path, phase12_ms: float) -> dict:
    """Phase 13: 13a-13f.  -> the kernels' launches on every rank."""
    seconds = []

    def timed(part, *args):
        t0 = time.perf_counter()
        out = part(*args)
        seconds.append(f"{time.perf_counter() - t0:.1f}")
        return out

    # 13a's dry run and 13e's torchrun, processes of their own, beside 13b-d
    # and 13f's spawn and 13c's: their times are taken under each other's
    # load
    with ThreadPoolExecutor(1) as pool:
        side = pool.submit(lambda: (timed(phase_dp_dryrun),
                                    timed(phase_dp_cli, tmp)))
        ranks, serial_ms, space_runs = timed(phase_dp_ranks, dev, bank, tmp)
        nccl = timed(phase_dp_nccl, tmp, serial_ms, phase12_ms)
        dry, cli = side.result()
    total = {name: sum(p[name] for p in (dry, ranks, nccl, cli))
             for name in KERNELS}
    line("phase 13 launches", ranks=json.dumps(total).replace(" ", ""),
         seconds="/".join(seconds), nvidia_smi=repr(nvidia_smi(dev.index or 0)))
    return total, space_runs


SPACE_WORLD = 2      # 14a-14c: a (1, 2) mesh over phase 13's two ranks
SPACE_DRYRUN_WORLD = 4
# every global op: the conditional gamma (first, so that its histogram is of
# the demosaic's output, the same on a window as on the frame), grayworld,
# whiteworld, reinhard
SPACE_GLOBAL = "Bayer_02_Demosaic_03_sRGB_16_05_06_02"
SPACE_APPLY = (SLICE1, SLICE2, SPACE_GLOBAL)
# A window against the whole frame, served: the same ops on the same rows,
# but each rank's convolutions run at the window's height, where cuDNN may
# choose other algorithms (rounding only, as ZOO_TOL's card against the
# CPU), and the global ops' sums run over each rank's owned rows and then
# across the group (1e-7 relative); the median and the quantile select
# among values that moved by that much.  So ZOO_TOL, as ARTIFACT_TOL.
SPACE_TOL = 1e-4


def _space_rank(dev, tmp: Path, inputs: dict, bank) -> dict:
    """14a-14c on this rank over a (1, 2) mesh of phase 13's two ranks,
    each run's counts set to 0 just before it and read just after; the
    unsharded runs on this rank alone."""
    start = time.perf_counter()
    mesh = meshlib.make_mesh(SPACE_WORLD, space=SPACE_WORLD)
    frames = make_frames(dev)
    out = {"mesh": tuple(mesh.shape), "apply": {}}

    def served_by(fn, x):
        torch.cuda.synchronize()
        _zero_counts()
        t0 = time.perf_counter()
        y = fn(x)
        torch.cuda.synchronize()
        return y, _counts(), time.perf_counter() - t0

    def held(y, want, launches, s, **extra):
        return {"diff": float((y - want).abs().max()), "shape": tuple(y.shape),
                "finite": bool(torch.isfinite(y).all()),
                "range": (float(y.min()), float(y.max())),
                "launches": launches, "s": s, **extra}

    slice2 = None
    for arch in SPACE_APPLY:
        pipe = load_pipeline(dev, arch, bank=bank)
        halo = space.radius(pipe)
        apply = make_data_parallel_apply(lambda v, x: pipe(x), mesh,
                                         halo=halo)
        with torch.inference_mode():
            y, launches, s = served_by(lambda x: apply(None, x), frames)
        want, _, whole_s = served_by(make_serving_fn(pipe, device=dev),
                                     frames)
        out["apply"][arch] = held(
            y, want, launches, s, whole_s=whole_s, halo=halo,
            window=space.window(FRAME[0], 0, SPACE_WORLD, halo).rows)
        if arch == SLICE2:
            slice2 = pipe
        del y, want
    torch.cuda.empty_cache()

    served = load_artifact(str(tmp / "space2.rispt"), device=dev)
    y, launches, s = served_by(served, frames[:1])
    want = make_serving_fn(slice2, device=dev)(frames[:1])
    out["artifact"] = held(y, want, launches, s, meta=served.meta)
    del served, y, want, frames, slice2
    torch.cuda.empty_cache()

    opt = search_options(SID_SEARCH)
    trainer = make_search_trainer(dev, bank, opt, mesh=mesh)
    run = _captured_steps(trainer, _to(inputs["search"], dev), timed_from=1)
    out["search"] = {"logs": run["logs"], "launches": run["launches"],
                     "ms": run["ms"], "eager": trainer.graph is None,
                     "window": trainer.space.window(
                         opt["datasets"]["train"]["data_size"]).rows,
                     "state": _state_out(trainer)}
    _, use_proxy, train_opt, _, _ = sid_isp_options()
    trainer = make_trainer(dev, SLICE2, use_proxy, bank, train_opt, mesh=mesh)
    batch = _to(inputs["isp"], dev)
    run = _train_run(trainer, batch, DP_ISP_STEPS, 1)
    out["isp"] = {k: run[k] for k in ("losses", "logits", "launches", "ms")}
    out["isp"]["window"] = trainer.space.window(batch["noisy"].shape[1]).rows
    out["s"] = time.perf_counter() - start
    return out


def phase_space(dev, ranks: list, ref: dict) -> dict:
    """Phase 14: 14a-14c as the ranks of phase 13's spawn ran them, each
    held against its unsharded run; then 14d.  -> the kernels' launches
    on every rank."""
    t0 = time.perf_counter()
    total = {name: 0 for name in KERNELS}
    for r, got in enumerate(ranks):
        sp = got["space"]
        if sp["mesh"] != (1, SPACE_WORLD):
            raise AssertionError(f"rank {r}: mesh {sp['mesh']}")
        for arch, run in sp["apply"].items():
            share = 2 * run["halo"] / (FRAME[0] / SPACE_WORLD)
            line("phase 14a space apply", rank=r, arch=arch,
                 mesh=sp["mesh"], frames=(2, *FRAME, 1), halo=run["halo"],
                 window_rows=run["window"], halo_share=f"{share:.4f}",
                 max_abs_diff=f"{run['diff']:.3e}", tol=SPACE_TOL,
                 s=f"{run['s']:.3f}", whole_frame_s=f"{run['whole_s']:.3f}",
                 launches=json.dumps(run["launches"]).replace(" ", ""))
            expected = {name: 1 if name in PATHS.get(arch, ()) else 0
                        for name in KERNELS}
            lo, hi = run["range"]
            if not (run["diff"] <= SPACE_TOL and run["finite"]
                    and 0.0 <= lo and hi <= 1.0
                    and run["shape"] == (2, *FRAME, 3)
                    and run["launches"] == expected):
                raise AssertionError(f"14a {arch} rank {r}: {run}")
        art = sp["artifact"]
        line("phase 14b space artifact", rank=r, arch=SLICE2,
             mesh=json.dumps(art["meta"]["mesh"]).replace(" ", ""),
             halo=art["meta"]["halo"], out=art["shape"],
             max_abs_diff=f"{art['diff']:.3e}", tol=SPACE_TOL,
             export_s=f"{ref['space_export']['s']:.1f}",
             mb=f"{ref['space_export']['mb']:.2f}",
             first_call_s=f"{art['s']:.2f}",
             launches=json.dumps(art["launches"]).replace(" ", ""))
        if not (art["diff"] <= SPACE_TOL and art["finite"]
                and art["shape"] == (1, *FRAME, 3)
                and art["meta"]["mesh"] == {"data": 1, "space": SPACE_WORLD}
                and art["launches"] == {"bilateral": 0, "median": 1,
                                        "fastnlm": 1}):
            raise AssertionError(f"14b rank {r}: {art}")

        search = sp["search"]
        line("phase 14c SID_search", rank=r, mesh=sp["mesh"],
             eager=search["eager"], window_rows=search["window"],
             batch=ref["batch"], steps=DP_SEARCH_STEPS,
             ms_per_step=f"{search['ms']:.3f}",
             serial_captured_ms_per_step=f"{ref['search']['ms']:.3f}",
             launches=json.dumps(search["launches"]).replace(" ", ""))
        _hold_dispatch(f"14c SID_search rank {r}",
                       types.SimpleNamespace(**search["state"]),
                       types.SimpleNamespace(**ref["search"]["state"]),
                       search["logs"], ref["search"]["logs"],
                       phase="phase 14c space mesh vs serial")
        if not search["eager"] or search["launches"] != {
                name: 15 * DP_SEARCH_STEPS for name in KERNELS}:
            raise AssertionError(f"14c rank {r}: {search['launches']}")
        isp = sp["isp"]
        loss = max(abs(a - b) / abs(b) for a, b in zip(
            isp["losses"], ref["isp"]["losses"]))
        logit = max(float(np.abs(isp["logits"][k] - v).max())
                    for k, v in ref["isp"]["logits"].items())
        line("phase 14c SID_isp", rank=r, arch=SLICE2, mesh=sp["mesh"],
             window_rows=isp["window"], steps=DP_ISP_STEPS,
             ms_per_step=f"{isp['ms']:.3f}",
             serial_ms_per_step=f"{ref['isp']['ms']:.3f}",
             max_loss_rel_diff=f"{loss:.3e}", loss_rtol=TRAIN_LOSS_RTOL,
             max_logit_diff=f"{logit:.3e}", logit_tol=TRAIN_LOGIT_TOL,
             launches=json.dumps(isp["launches"]).replace(" ", ""))
        if not (loss <= TRAIN_LOSS_RTOL and logit <= TRAIN_LOGIT_TOL) \
                or isp["launches"] != {"bilateral": 0, "median": DP_ISP_STEPS,
                                       "fastnlm": DP_ISP_STEPS}:
            raise AssertionError(f"14c SID_isp rank {r}")
        for name in KERNELS:
            total[name] += (sum(run["launches"][name]
                                for run in sp["apply"].values())
                            + art["launches"][name]
                            + search["launches"][name]
                            + isp["launches"][name])
    reported_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    out = dryrun_multichip(SPACE_DRYRUN_WORLD, "cuda")
    dry = [r[-1] for r in out["launches"]]
    dry_s = time.perf_counter() - t0
    line("phase 14d dryrun_multichip", world=SPACE_DRYRUN_WORLD,
         backend="gloo", mesh=json.dumps(out["mesh"]).replace(" ", ""),
         checks=" | ".join(out["lines"]).replace(" ", "_"),
         rank_launches=json.dumps(dry).replace(" ", ""),
         seconds=f"{dry_s:.1f}")
    if out["mesh"] != {"data": 2, "space": 2} or any(
            r != {"bilateral": 5, "median": 0, "fastnlm": 0} for r in dry):
        raise AssertionError(f"14d dry run: {out['mesh']} {dry}")
    for name in KERNELS:
        total[name] += sum(r[name] for r in dry)
    line("phase 14 launches", ranks=json.dumps(total).replace(" ", ""),
         ranks_s="/".join(f"{got['space']['s']:.1f}" for got in ranks),
         report_s=f"{reported_s:.1f}", dryrun_s=f"{dry_s:.1f}",
         nvidia_smi=repr(nvidia_smi(dev.index or 0)))
    return total


# ----------------------------------------------------------------- phase 15

# Phase 15: the method's accuracy tools and the real-scale rehearsal
# (reconfigisp_tpu_torch/tools/), in subprocesses through run_cli, 15a's
# beside 15b's.
# Cuts (steps, never geometry): the planted demo's seeds 2 of 3, its
# pretraining 20 of 3,000 steps, 6 of 1,500 search steps a leg (darts_ft's
# tuning interval 50 cut to 6, so one round fires), 20 of 800 step-2 steps
# (and of ft_divergence's 700), 4 of 16 held-out frames; the rehearsal's
# search 2 of 600 steps
# (S7's tuning interval is the tool's own, max(2, min(50, iters // 2))),
# learning 3 of 1,200, one test frame a leg, every frame at full size.
PLANTED_SMOKE = {"--pretrain-steps": 20, "--search-iters": 6,
                 "--ft-interval": 6, "--isp-iters": 20, "--eval-frames": 4}
PLANTED_SEEDS = (0, 1)
PLANTED_FT_STEPS = 4         # planted_search_ft.yaml's ft_steps
REHEARSAL_ITERS, REHEARSAL_LEARN = 2, 3
REHEARSAL_FT_STEPS = 2       # the rehearsal's S7 ft_steps
# Held-out PSNR of one trained state on the card against the CPU.  The
# outputs differ by the convs' summation order (ZOO_TOL bounds a pipeline's
# values at 1e-4; about 1e-6 in phase 5): a difference d moves a PSNR by
# about (10 / ln 10) 2 d / r, 2e-4 dB for d = 1e-6 and residuals r = 0.05;
# 5x over that.
EVAL_PSNR_TOL_DB = 1e-3


def _finite(*values) -> bool:
    return all(v is not None and math.isfinite(float(v)) for v in values)


def _planted_clis(out: Path) -> tuple:
    """tools/planted_demo.py at PLANTED_SMOKE's budgets over PLANTED_SEEDS,
    then tools/ft_divergence.py over every seed, into `out` -> their run_cli
    results."""
    budget = [a for k, v in PLANTED_SMOKE.items() for a in (k, str(v))]
    demo = run_cli("reconfigisp_tpu_torch.tools.planted_demo", "--seeds",
                   ",".join(map(str, PLANTED_SEEDS)), *budget, "--out",
                   str(out), timeout=900)
    ft = run_cli("reconfigisp_tpu_torch.tools.ft_divergence", "--isp-iters",
                 str(PLANTED_SMOKE["--isp-iters"]), "--eval-frames",
                 str(PLANTED_SMOKE["--eval-frames"]), "--out", str(out))
    return demo, ft


def phase_planted(dev, out: Path, demo: dict, ft: dict) -> dict:
    """15a, on _planted_clis' runs into `out`: for each seed every decoded
    architecture builds, every loss and the margin are finite, and each
    step-2 training lowers its loss on its first batch (or moves no
    parameter, none getting a gradient); the cross-seed aggregates cover
    every seed; and seed 0's searched architecture's trained state scores
    the same held-out PSNR on the card and on the CPU.  -> the kernels'
    launches of both processes."""
    t0 = time.perf_counter()
    res = json.loads((out / "results.json").read_text())
    if res["device"].get("type") != "cuda" or not res["device"]["nvidia_smi"]:
        raise AssertionError(f"15a device record: {res['device']}")
    for s in PLANTED_SEEDS:
        _check_planted_seed(dev, s, res["seeds"][str(s)])
    gap = res["ft_divergence_psnr_gap_db"]
    keys = {str(s) for s in PLANTED_SEEDS}
    if not (res["seeds_finished"] == len(PLANTED_SEEDS)
            and res["seeds_pending"] == 0
            and set(res["margin_db_per_seed"]) == keys
            and set(gap["per_seed"]) == keys
            and _finite(res["margin_db_mean"], res["margin_db_std"],
                        gap["mean"])):
        raise AssertionError(f"15a aggregates: {res}")

    arch = res["seeds"]["0"]["search_native"]["architecture"]
    pipe, _ = planted_demo.train_fixed(
        arch, PLANTED_SMOKE["--isp-iters"], proxies=str(out / "proxies.ckpt"),
        device=dev)
    n = PLANTED_SMOKE["--eval-frames"]
    card = planted_demo.eval_psnr(pipe, n=n)
    cpu = planted_demo.eval_psnr(Pipeline(arch, device="cpu").load_state(
        convert.state_from_jax(convert.state_to_jax(pipe))), n=n)
    launches = {name: demo["launches"][name] + ft["launches"][name]
                for name in KERNELS}
    least = {name: PLANTED_SMOKE["--pretrain-steps"] + len(PLANTED_SEEDS)
             * (15 * PLANTED_SMOKE["--search-iters"] + PLANTED_FT_STEPS)
             for name in KERNELS}
    line("phase 15a planted", arch=arch,
         margin_db=json.dumps(res["margin_db_per_seed"]).replace(" ", ""),
         margin_mean_db=res["margin_db_mean"],
         margin_std_db=res["margin_db_std"],
         ft_gap_db=json.dumps(gap["per_seed"]).replace(" ", ""),
         card_psnr_db=f"{card:.6f}",
         cpu_psnr_db=f"{cpu:.6f}", diff_db=f"{abs(card - cpu):.3e}",
         tol_db=EVAL_PSNR_TOL_DB, demo_s=f"{demo['seconds']:.1f}",
         ft_divergence_s=f"{ft['seconds']:.1f}",
         launches=json.dumps(launches).replace(" ", ""),
         at_least=json.dumps(least).replace(" ", ""),
         check_s=f"{time.perf_counter() - t0:.1f}")
    if not abs(card - cpu) <= EVAL_PSNR_TOL_DB:
        raise AssertionError(f"15a eval_psnr: card {card}, cpu {cpu}")
    if any(launches[name] < least[name] for name in KERNELS):
        raise AssertionError(f"15a launches {launches} < {least}")
    return launches


def _check_planted_seed(dev, s: int, seed: dict) -> None:
    """15a's checks of one seed's legs, step-2 records and margin."""
    for leg in ("native", "proxy", "ft"):
        rec = seed[f"search_{leg}"]
        line("phase 15a search", seed=s, leg=leg, arch=rec["architecture"],
             iters=rec["iters"], loss=f"{rec['loss']:.6e}",
             val_loss=f"{rec['val_loss']:.6e}", s=rec["seconds"])
        Pipeline(rec["architecture"], device=dev)
        if rec["iters"] != PLANTED_SMOKE["--search-iters"] or not _finite(
                rec["loss"], rec["val_loss"]):
            raise AssertionError(f"15a seed {s} {leg} search: {rec}")
    trained = {**seed["step2_psnr"],
               **{f"ft_divergence_{k}": v
                  for k, v in seed["leg_arch_psnr"].items()}}
    for what, rec in trained.items():
        line("phase 15a step 2", seed=s, what=what, arch=rec["architecture"],
             steps=PLANTED_SMOKE["--isp-iters"],
             train_loss=f"{rec['train_loss']:.6e}",
             probe_loss=f"{rec['probe_loss_start']:.6e}->"
                        f"{rec['probe_loss_final']:.6e}",
             logits_moved=f"{rec['logits_moved']:.3e}",
             psnr_db=f"{rec['psnr']:.4f}")
        Pipeline(rec["architecture"], device=dev)
        # the loss falls, unless no parameter of the pipeline gets a
        # gradient (whiteworld's quantile, the median's radius) and so the
        # pipeline is left as it was
        falls = (rec["probe_loss_final"] < rec["probe_loss_start"]
                 if rec["logits_moved"] > 0 else
                 rec["probe_loss_final"] == rec["probe_loss_start"])
        if not (_finite(rec["train_loss"], rec["psnr"]) and falls):
            raise AssertionError(f"15a seed {s} step 2 {what}: {rec}")
    if not _finite(seed["margin_db"]):
        raise AssertionError(f"15a seed {s}: margin {seed['margin_db']}")


def _rehearsal_cli(out: Path) -> dict:
    """tools/rehearse_real_scale.py's SID and S7 legs at full frame size,
    REHEARSAL_ITERS search and REHEARSAL_LEARN learning steps, into `out`
    -> its run_cli result."""
    return run_cli("reconfigisp_tpu_torch.tools.rehearse_real_scale",
                   "--legs", "sid,s7", "--iters", str(REHEARSAL_ITERS),
                   "--learn-iters", str(REHEARSAL_LEARN), "--out", str(out),
                   timeout=900)


def phase_rehearsal(out: Path, run: dict) -> dict:
    """15b, on _rehearsal_cli's run into `out`: the steps as asked, finite
    losses and test PSNR (one tiled frame a leg); the kernels launch 15 a
    SID search step and once a step of S7's tuning round.  -> the kernels'
    launches."""
    res = json.loads((out / "results.json").read_text())
    for leg, search in (("sid", "search"), ("s7", "search_ft")):
        s, isp, test = res[leg][search], res[leg]["isp"], res[leg]["test"]
        line(f"phase 15b {leg}", search_arch=s["architecture"],
             search_steps=s["steps_run"], search_loss=f"{s['loss']:.6e}",
             search_steady_s=s["steady_s_per_iter"],
             isp_steps=isp["steps_run"],
             isp_loss=f"{isp['loss_first']:.6e}->{isp['loss']:.6e}",
             isp_val_psnr=f"{isp['val_psnr_start']:.3f}->"
                          f"{isp['val_psnr_final']:.3f}",
             isp_steady_s=isp["steady_s_per_iter"],
             test_psnr_mean=test.get("psnr_mean"))
        if not (s["steps_run"] == REHEARSAL_ITERS
                and isp["steps_run"] == REHEARSAL_LEARN
                and _finite(s["loss"], s["loss_first"], isp["loss"],
                            isp["loss_first"], isp["val_psnr_final"],
                            test.get("psnr_mean"))):
            raise AssertionError(f"15b {leg}: {res[leg]}")
    expected = {name: 15 * REHEARSAL_ITERS + REHEARSAL_FT_STEPS
                for name in KERNELS}
    line("phase 15b launches", launches=json.dumps(run["launches"])
         .replace(" ", ""), expected=json.dumps(expected).replace(" ", ""),
         peak_mib=f"{run['peak_bytes'] / 2**20:.0f}",
         seconds=f"{run['seconds']:.1f}")
    if run["launches"] != expected:
        raise AssertionError(f"15b launches {run['launches']} != {expected}")
    return run["launches"]


# ----------------------------------------------------------------- phase 16

# Phase 16: the rehearsal's OnePlus/YOLO leg (tools/rehearse_real_scale.py
# --legs yolo) in a subprocess through run_cli, cv2 unimportable, beside
# phase 15's two.  Cuts (steps, never geometry): the criterion's
# pretraining 20 of 1,000 steps, the detection search 2 of 100, step 2 4 of
# 1,000 (the tool's floor), every frame at 3000x4000 and the test on the
# fixtures' 2 frames at 1024.
YOLO_LEG = {"--iters": 2, "--learn-iters": 4, "--criterion-iters": 20,
            "--yolo-search-iters": 2}


def _yolo_leg_cli(out: Path) -> dict:
    """The rehearsal's OnePlus/YOLO leg at YOLO_LEG's budgets, full frame
    size, into `out` -> its run_cli result."""
    budget = [a for k, v in YOLO_LEG.items() for a in (k, str(v))]
    return run_cli("reconfigisp_tpu_torch.tools.rehearse_real_scale",
                   "--legs", "yolo", *budget, "--out", str(out),
                   without=("cv2",), timeout=900)


def phase_yolo_leg(out: Path, run: dict) -> dict:
    """16, on _yolo_leg_cli's run into `out`: the first fixture's PNG read
    back equal to the mosaic drawn again here, the steps as asked, finite
    losses, the criterion's self-check, the test's `map=`, and the kernels'
    launches exact (15 a search step; yolo_isp.yaml's and yolo_test.yaml's
    pipeline has no kernel op).  -> the kernels' launches."""
    t0 = time.perf_counter()
    res = json.loads((out / "results.json").read_text())
    if res["device"].get("type") != "cuda" or not res["device"]["nvidia_smi"]:
        raise AssertionError(f"16 device record: {res['device']}")
    *_, mosaic = rehearsal.oneplus_frames(1)[0]
    frame = png.read(out / "data" / "oneplus" / "000.png")
    same = frame.dtype == mosaic.dtype and frame.shape == mosaic.shape \
        and bool(np.array_equal(frame, mosaic))
    line("phase 16 fixtures", frame=frame.shape, dtype=frame.dtype,
         max=int(frame.max()), png_equals_mosaic=same,
         png_mb=f"{(out / 'data' / 'oneplus' / '000.png').stat().st_size / 1e6:.1f}",
         check_s=f"{time.perf_counter() - t0:.1f}")
    leg = res["yolo"]
    crit, s, isp, test = (leg["criterion_pretrain"], leg["search"],
                          leg["isp"], leg["test"])
    line("phase 16 criterion", steps=crit["iters"],
         loss=f"{crit['loss_first']}->{crit['loss']}",
         selfcheck_top_conf=crit["selfcheck_top_conf"],
         compile_s=crit["compile_s"], steady_s=crit["steady_s_per_iter"])
    line("phase 16 search", arch=s["architecture"], steps=s["steps_run"],
         loss=f"{s['loss_first']:.6e}->{s['loss']:.6e}",
         compile_s=s["compile_s"], steady_s=s["steady_s_per_iter"])
    line("phase 16 isp", steps=isp["steps_run"],
         loss=f"{isp['loss_first']:.6e}->{isp['loss']:.6e}",
         probe_loss=f"{isp['probe_loss_start']:.6e}->"
                    f"{isp['probe_loss_final']:.6e}",
         compile_s=isp["compile_s"], steady_s=isp["steady_s_per_iter"])
    line("phase 16 test", map=test.get("map"))
    if not (same and crit["iters"] == YOLO_LEG["--criterion-iters"]
            and s["steps_run"] == YOLO_LEG["--yolo-search-iters"]
            and isp["steps_run"] == YOLO_LEG["--learn-iters"]
            and _finite(crit["loss_first"], crit["loss"],
                        crit["selfcheck_top_conf"], s["loss_first"],
                        s["loss"], isp["loss_first"], isp["loss"],
                        test.get("map"))):
        raise AssertionError(f"16: png {same}, {leg}")
    expected = {name: 15 * YOLO_LEG["--yolo-search-iters"]
                for name in KERNELS}
    line("phase 16 launches", launches=json.dumps(run["launches"])
         .replace(" ", ""), expected=json.dumps(expected).replace(" ", ""),
         peak_mib=f"{run['peak_bytes'] / 2**20:.0f}",
         seconds=f"{run['seconds']:.1f}")
    if run["launches"] != expected:
        raise AssertionError(f"16 launches {run['launches']} != {expected}")
    return run["launches"]


def phase_tools(dev, tmp: Path) -> tuple:
    """Phases 15 and 16: 15a's, 15b's and 16's processes side by side (each
    counts its own launches; the card and the host's cores have room for
    them), then their checks -> (15's launches, 16's launches)."""
    t0 = time.perf_counter()
    planted_out, rehearsal_out = tmp / "planted", tmp / "rehearsal"
    yolo_out = tmp / "rehearsal_yolo"
    with ThreadPoolExecutor(3) as pool:
        planted_runs = pool.submit(_planted_clis, planted_out)
        rehearsal_run = pool.submit(_rehearsal_cli, rehearsal_out)
        yolo_run = pool.submit(_yolo_leg_cli, yolo_out)
        demo, ft = planted_runs.result()
        run = rehearsal_run.result()
        yolo = yolo_run.result()
    planted = phase_planted(dev, planted_out, demo, ft)
    rehearsed = phase_rehearsal(rehearsal_out, run)
    total = {name: planted[name] + rehearsed[name] for name in KERNELS}
    line("phase 15 launches", planted=json.dumps(planted).replace(" ", ""),
         rehearsal=json.dumps(rehearsed).replace(" ", ""),
         seconds=f"{time.perf_counter() - t0:.1f}")
    return total, phase_yolo_leg(yolo_out, yolo)


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
    train_launches, train_ms = phase_training(dev, bank)
    phase_gradients(dev)
    phase_latency(dev)
    search_launches, search_ms = phase_search(dev, bank)
    with tempfile.TemporaryDirectory() as root:
        tmp = Path(root)
        entry = phase_entry_points(dev, bank, train_ms[SLICE2], search_ms,
                                   tmp)
        yolo_launches = phase_yolo(dev, bank)
        artifact_launches = phase_deployment(dev, bank)
        graph_launches, dispatch_ms = phase_dispatch(dev, bank)
        dp_launches, space_runs = phase_data_parallel(dev, bank, tmp,
                                                      dispatch_ms)
        space_launches = phase_space(dev, *space_runs)
        accuracy_launches, yolo_leg_launches = phase_tools(dev, tmp)

    kernels = [{
        "name": name, "route": "cuda",
        "source": f"reconfigisp_tpu_torch/csrc/{name}.cu",
        "replaces": replaces, "launches": launches[name],
        "train_launches": train_launches[name],
        "search_launches": search_launches[name],
        "pretrain_launches": entry["pretrain"][name],
        "entry_point_launches": entry["entry"][name],
        "yolo_launches": yolo_launches[name],
        "artifact_launches": artifact_launches[name],
        "graph_launches": graph_launches[name],
        "dp_launches": dp_launches[name],
        "space_launches": space_launches[name],
        "accuracy_launches": accuracy_launches[name],
        "yolo_leg_launches": yolo_leg_launches[name],
        "max_abs_err": max_err[name], **times[name], "library_ms": None,
    } for name, (*_, replaces) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

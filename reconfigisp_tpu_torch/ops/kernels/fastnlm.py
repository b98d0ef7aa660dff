"""Fast non-local means: the Hopper kernel's wrapper and its plain form.

The kernel (csrc/fastnlm.cu) replaces the TPU kernel
reconfigisp_tpu/ops/pallas_kernels.py:fastnlm_pallas.  It is the custom op
`reconfigisp::fastnlm` (_vjp.windowed_op), which launches the kernel for a
CUDA tensor and counts the launch in `launches`, and for a tensor on the CPU
computes `fastnlm_plain`, the form of
reconfigisp_tpu/ops/denoise.py:_fastnlm_jnp over the whole frame, border
rule included, which is also the kernel's reference on the card.  (The
Pallas kernel boxes differences of the reflect-padded image, so near the
frame edges it differs from both.)  The kernel sums each box horizontally
first and takes exp2 of the box sum times one scale per image, where this
form divides by 2b+1 twice and by h^2 and takes exp: the two agree within
5e-5.  The op's backward is fastnlm_plain's gradient, as the JAX backward
differentiates _fastnlm_jnp: on the card a backward kernel of its own
(csrc/fastnlm.cu's fastnlm_backward, `backward_launches` its launches),
which recomputes y and the clip's mask in the plain form's arithmetic and
sums the gradient in another order, within 1e-4 of the largest gradient
value; on the CPU the plain form's autograd (_vjp.vjp).  So a CUDA input
that requires grad launches the forward kernel too; `fastnlm` calls the op,
except for a CPU input that autograd differentiates, which runs
fastnlm_plain itself.  One output row reaches HALO rows of input: the
search radius and the block radius, 7 each at most.

x (N, H, W, C) float32 in [0, 1]; params (N, 3) in [0, 1]:
[block01, search01, decay01].  The block radius comes from params[0, 0] for
the whole batch; the search radius (both clip(floor(7 p), 0, 6) + 1) and the
decay h = 1 + 99 decay01 (0..255 scale) are per image.
"""

from __future__ import annotations

from typing import Optional

import torch

from reconfigisp_tpu_torch.ops.kernels import _build
from reconfigisp_tpu_torch.ops.kernels._build import MAX_R
from reconfigisp_tpu_torch.ops.kernels import _vjp
from reconfigisp_tpu_torch.ops.kernels.bilateral import size01_to_radius
from reconfigisp_tpu_torch.ops.nn import clip, reflect

HALO = 2 * MAX_R
OFFSETS = (2 * MAX_R + 1) ** 2
# float32 values each of the backward kernel's two per-offset fields holds
# at most: a launch group's offsets times N H W C
SCRATCH_VALUES = 1 << 23

launches = 0  # kernel launches since the caller last set it to 0
backward_launches = 0  # backward kernel launches, the same way


def box_filter(d: torch.Tensor, b: int) -> torch.Tensor:
    """(2b+1)^2 mean over NCHW with reflect padding of d itself: rows summed
    and divided by 2b+1, then columns, in _box_filter's order."""
    k = 2 * b + 1
    h, w = d.shape[2:]
    rows = reflect(d, b, 2)
    acc = sum(rows[:, :, i:i + h] for i in range(k)) / k
    cols = reflect(acc, b, 3)
    return sum(cols[:, :, :, i:i + w] for i in range(k)) / k


def box_filter_static(d: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """box_filter with the block radius b a 0-d device tensor, read on the
    device only: the 2 MAX_R + 1 row offsets of reflect(d, MAX_R), each
    times the mask |i| <= b, summed in box_filter's order and divided by
    2b+1, then the columns alike.  Within b rows a reflection of width MAX_R
    is one of width b, the masked terms add exact zeros, and the division
    rounds as box_filter's: the same sums bit for bit, value and
    gradient."""
    h, w = d.shape[2:]
    offsets = torch.arange(-MAX_R, MAX_R + 1, device=d.device)
    mask = (offsets.abs() <= b).to(d.dtype)
    k = (2 * b + 1).to(d.dtype)
    # torch multiplies a CUDA tensor divided by a Python number by its
    # reciprocal and divides a CPU tensor: the same roundings here
    div = ((lambda t: t * torch.reciprocal(k)) if d.is_cuda
           else (lambda t: t / k))
    span = range(2 * MAX_R + 1)
    rows = reflect(d, MAX_R, 2)
    acc = div(sum(rows[:, :, i:i + h] * mask[i] for i in span))
    cols = reflect(acc, MAX_R, 3)
    return div(sum(cols[:, :, :, i:i + w] * mask[i] for i in span))


def fastnlm_plain(x: torch.Tensor, params: torch.Tensor,
                  static: Optional[bool] = None) -> torch.Tensor:
    """Search offsets in _fastnlm_jnp's order, column offset outer and row
    offset inner.  Offsets beyond the largest search radius in the batch
    carry zero weight for every image and are not visited.

    On the capture-safe route (_vjp.bounds_static, or `static`) no radius
    is read on the host: the offsets run to MAX_R, as _fastnlm_jnp's do,
    and the block is box_filter_static, the device's choice where
    _fastnlm_jnp switches.  The offsets' squared differences are stacked
    and box-filtered in one pass (a box sum runs along rows and columns, so
    each value's sum is the same), which keeps the graph a capture records
    near the host-read route's size; the weights and the sums into num and
    den stay one offset at a time, in order.  The same value and gradients
    bit for bit."""
    n, h, w, c = x.shape
    static = _vjp.bounds_static(x, static)
    search = size01_to_radius(params[:, 1])[:, None, None, None]
    inv_h2 = 1.0 / ((1.0 + 99.0 * params[:, 2]) ** 2)[:, None, None, None]
    x255 = (x * 255.0).permute(0, 3, 1, 2)
    padded = reflect(reflect(x255, MAX_R, 2), MAX_R, 3)
    s_max = MAX_R if static else int(search.max())
    offsets = [(dx, dy) for dx in range(-s_max, s_max + 1)
               for dy in range(-s_max, s_max + 1)]

    def tap_at(dx, dy):
        return padded[:, :, MAX_R + dy:MAX_R + dy + h,
                      MAX_R + dx:MAX_R + dx + w]

    if static:
        taps = [tap_at(dx, dy) for dx, dy in offsets]
        diffs = torch.stack([tap - x255 for tap in taps])
        boxed = box_filter_static((diffs ** 2).flatten(0, 1),
                                  size01_to_radius(params[0, 0]))
        d2s = boxed.unflatten(0, (len(offsets), n)).unbind(0)
    else:
        b = int(size01_to_radius(params[0, 0]))
    num = torch.zeros_like(x255)
    den = torch.zeros_like(x255)
    for i, (dx, dy) in enumerate(offsets):
        if static:
            tap, d2 = taps[i], d2s[i]
        else:
            tap = tap_at(dx, dy)
            d2 = box_filter((tap - x255) ** 2, b)
        include = (max(abs(dy), abs(dx)) <= search).to(x.dtype)
        wgt = include * torch.exp(-d2 * inv_h2)
        num = num + wgt * tap
        den = den + wgt
    out = (num / clip(den, 1e-8)).permute(0, 2, 3, 1)
    return clip(out / 255.0, 0.0, 1.0)


def _count(n: int) -> None:
    global launches
    launches += n


def _count_backward(n: int) -> None:
    global backward_launches
    backward_launches += n


def backward_group(x: torch.Tensor) -> int:
    """Search offsets a launch group of the backward kernel covers: as many
    as keep its per-offset fields within SCRATCH_VALUES, all 225 at the
    search step's 4 x 48^2 x 3."""
    return max(1, min(OFFSETS, SCRATCH_VALUES // x.numel()))


def backward_kernel(x: torch.Tensor, params: torch.Tensor, g: torch.Tensor):
    """The backward kernel on CUDA tensors -> (gx, gp, launches)."""
    return _build.launch_backward("fastnlm", x, params, g, 3,
                                  backward_group(x))


op = _vjp.windowed_op("fastnlm", fastnlm_plain, 3, HALO, _count,
                      (backward_kernel, _count_backward))


def fastnlm(x: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """The op (the CUDA kernel for a CUDA tensor, the plain form for a CPU
    tensor), or fastnlm_plain itself where _vjp.plain_here says so."""
    if _vjp.plain_here("fastnlm", x, params):
        return fastnlm_plain(x, params)
    return op(x, params)

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
differentiates _fastnlm_jnp, so a CUDA input that requires grad launches the
kernel too; `fastnlm` calls the op, except for a CPU input that autograd
differentiates, which runs fastnlm_plain itself.  One output row reaches
HALO rows of input: the search radius and the block radius, 7 each at most.

x (N, H, W, C) float32 in [0, 1]; params (N, 3) in [0, 1]:
[block01, search01, decay01].  The block radius comes from params[0, 0] for
the whole batch; the search radius (both clip(floor(7 p), 0, 6) + 1) and the
decay h = 1 + 99 decay01 (0..255 scale) are per image.
"""

from __future__ import annotations

import torch

from reconfigisp_tpu_torch.ops.kernels import _build
from reconfigisp_tpu_torch.ops.kernels._build import MAX_R
from reconfigisp_tpu_torch.ops.kernels import _vjp
from reconfigisp_tpu_torch.ops.kernels.bilateral import size01_to_radius
from reconfigisp_tpu_torch.ops.nn import clip, reflect

HALO = 2 * MAX_R

launches = 0  # kernel launches since the caller last set it to 0


def box_filter(d: torch.Tensor, b: int) -> torch.Tensor:
    """(2b+1)^2 mean over NCHW with reflect padding of d itself: rows summed
    and divided by 2b+1, then columns, in _box_filter's order."""
    k = 2 * b + 1
    h, w = d.shape[2:]
    rows = reflect(d, b, 2)
    acc = sum(rows[:, :, i:i + h] for i in range(k)) / k
    cols = reflect(acc, b, 3)
    return sum(cols[:, :, :, i:i + w] for i in range(k)) / k


def fastnlm_plain(x: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """Search offsets in _fastnlm_jnp's order, column offset outer and row
    offset inner.  Offsets beyond the largest search radius in the batch
    carry zero weight for every image and are not visited."""
    n, h, w, c = x.shape
    b = int(size01_to_radius(params[0, 0]))
    search = size01_to_radius(params[:, 1])[:, None, None, None]
    inv_h2 = 1.0 / ((1.0 + 99.0 * params[:, 2]) ** 2)[:, None, None, None]
    x255 = (x * 255.0).permute(0, 3, 1, 2)
    padded = reflect(reflect(x255, MAX_R, 2), MAX_R, 3)
    s_max = int(search.max())
    num = torch.zeros_like(x255)
    den = torch.zeros_like(x255)
    for dx in range(-s_max, s_max + 1):
        for dy in range(-s_max, s_max + 1):
            tap = padded[:, :, MAX_R + dy:MAX_R + dy + h,
                         MAX_R + dx:MAX_R + dx + w]
            d2 = box_filter((tap - x255) ** 2, b)
            include = (max(abs(dy), abs(dx)) <= search).to(x.dtype)
            wgt = include * torch.exp(-d2 * inv_h2)
            num = num + wgt * tap
            den = den + wgt
    out = (num / clip(den, 1e-8)).permute(0, 2, 3, 1)
    return clip(out / 255.0, 0.0, 1.0)


def _count() -> None:
    global launches
    launches += 1


op = _vjp.windowed_op("fastnlm", fastnlm_plain, 3, HALO, _count)


def fastnlm(x: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """The op (the CUDA kernel for a CUDA tensor, the plain form for a CPU
    tensor), or fastnlm_plain itself where _vjp.plain_here says so."""
    if _vjp.plain_here("fastnlm", x, params):
        return fastnlm_plain(x, params)
    return op(x, params)

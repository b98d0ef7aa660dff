"""Bilateral filter: the Hopper kernel's wrapper and its plain PyTorch form.

The kernel (csrc/bilateral.cu) replaces the TPU kernel
reconfigisp_tpu/ops/pallas_kernels.py:bilateral_pallas.  `bilateral` is the
one place that chooses: it launches the kernel for a CUDA tensor and counts
the launch in `launches`; for a tensor on the CPU it computes
`bilateral_plain`, the same function in PyTorch (the form of
reconfigisp_tpu/ops/denoise.py:_bilateral_jnp), which is also the kernel's
reference on the card.  The kernel has no backward yet, so on CUDA it
refuses inputs that require grad.

x (N, H, W, C) float32 in [0, 1]; params (N, 3) in [0, 1]:
[window01, sigma_color01, sigma_space01]; radius = clip(floor(7 window01),
0, 6) + 1 and sigma = 1 + 99 sigma01 on the 0..255 scale.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from reconfigisp_tpu_torch.ops.kernels import _build

MAX_R = 7

launches = 0  # kernel launches since the caller last set it to 0


def size01_to_radius(p: torch.Tensor) -> torch.Tensor:
    """[0,1] -> integer radius in {1..7} (window {3..15})."""
    return torch.clamp(torch.floor(p * 7.0), 0, 6).to(torch.int32) + 1


def pad_reflect(x: torch.Tensor, r: int) -> torch.Tensor:
    """NHWC reflect padding (the edge pixel is not repeated)."""
    xp = F.pad(x.permute(0, 3, 1, 2), (r, r, r, r), mode="reflect")
    return xp.permute(0, 2, 3, 1)


def bilateral_plain(x: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """Tap loop over column offsets (outer) and row offsets (inner), as
    _bilateral_jnp sums them.  Offsets beyond the largest radius in the batch
    carry zero weight for every image and are not visited."""
    n, h, w, c = x.shape
    radius = size01_to_radius(params[:, 0])[:, None, None, None]
    sigma_color = (1.0 + 99.0 * params[:, 1])[:, None, None, None]
    sigma_space = (1.0 + 99.0 * params[:, 2])[:, None, None, None]
    inv_2sc2 = 0.5 / (sigma_color ** 2)
    inv_2ss2 = 0.5 / (sigma_space ** 2)
    x255 = x * 255.0
    padded = pad_reflect(x255, MAX_R)
    r_max = int(radius.max())
    num = torch.zeros_like(x255)
    den = torch.zeros_like(x255)
    for dx in range(-r_max, r_max + 1):
        for dy in range(-r_max, r_max + 1):
            tap = padded[:, MAX_R + dy:MAX_R + dy + h,
                         MAX_R + dx:MAX_R + dx + w, :]
            include = (max(abs(dy), abs(dx)) <= radius).to(x.dtype)
            w_space = torch.exp(-(dy * dy + dx * dx) * inv_2ss2)
            w_color = torch.exp(-((tap - x255) ** 2) * inv_2sc2)
            wgt = include * w_space * w_color
            num = num + wgt * tap
            den = den + wgt
    out = num / torch.clamp(den, min=1e-8)
    return torch.clamp(out / 255.0, 0.0, 1.0)


def _check(x: torch.Tensor, params: torch.Tensor) -> None:
    if x.dtype != torch.float32 or params.dtype != torch.float32:
        raise TypeError(f"bilateral kernel takes float32, got {x.dtype} "
                        f"and {params.dtype}")
    if x.ndim != 4 or x.shape[3] not in (1, 3):
        raise ValueError(f"bilateral kernel takes (N, H, W, 1|3), got "
                         f"{tuple(x.shape)}")
    n, h, w, _ = x.shape
    if h <= MAX_R or w <= MAX_R or not 1 <= n <= 65535:
        raise ValueError(f"bilateral kernel needs H, W > {MAX_R} and "
                         f"1 <= N <= 65535, got {tuple(x.shape)}")
    if tuple(params.shape) != (n, 3):
        raise ValueError(f"params must be ({n}, 3), got {tuple(params.shape)}")
    if params.device != x.device:
        raise ValueError("x and params must be on the same device")


def _forward():
    """The C entry point bilateral_forward(x, params, out, n, h, w, c, stream)."""
    fn = _build.load("bilateral").bilateral_forward
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def bilateral(x: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel for a CUDA tensor, the plain form for a CPU tensor.
    The kernel reads contiguous NHWC, so other strides are copied first."""
    global launches
    if x.device.type == "cpu":
        return bilateral_plain(x, params)
    if x.device.type != "cuda":
        raise ValueError(f"bilateral runs on cuda or cpu, not {x.device}")
    if x.requires_grad or params.requires_grad:
        # the autograd Function with the plain form's backward comes with
        # the training slice
        raise RuntimeError(
            "bilateral on CUDA is forward-only: call it under "
            "torch.no_grad() or torch.inference_mode()")
    x, params = x.contiguous(), params.contiguous()
    _check(x, params)
    n, h, w, c = x.shape
    out = torch.empty_like(x)
    forward = _forward()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = forward(x.data_ptr(), params.data_ptr(), out.data_ptr(),
                     n, h, w, c, stream)
    if rc != 0:
        raise RuntimeError(f"bilateral kernel launch failed: CUDA error {rc}")
    launches += 1
    return out

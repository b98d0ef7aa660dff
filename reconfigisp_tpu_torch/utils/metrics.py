"""Image quality metrics: MSE, PSNR and SSIM on NHWC batches.

Counterpart of reconfigisp_tpu/utils/metrics.py (reference
codes/utils/util.py:141-154 and util_path_restore.py:6-44).  SSIM's window
sums run as an f32 convolution with TF32 off, as the JAX form asks for
Precision.HIGHEST.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def mse(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per image for a 4-d batch, else over everything."""
    if x.ndim == 4:
        return torch.mean((x - y) ** 2, dim=tuple(range(1, x.ndim)))
    return torch.mean((x - y) ** 2)


def psnr(x, y, max_val: float = 1.0) -> torch.Tensor:
    """10 log10(max^2 / mse), per image when batched."""
    m = torch.clamp(mse(x, y), min=1e-12)
    return 10.0 * torch.log10(max_val ** 2 / m)


def _gaussian_window(device) -> torch.Tensor:
    """The 11x11 Gaussian window with sigma 1.5, summing to 1."""
    g = torch.exp(-0.5 * ((torch.arange(11, dtype=torch.float32) - 5.0)
                          / 1.5) ** 2)
    g = g / g.sum()
    return torch.outer(g, g)[None, None].to(device)


def ssim(x, y, max_val: float = 1.0) -> torch.Tensor:
    """Gaussian-windowed SSIM (Wang et al. 2004), VALID windows, per image,
    mean over channels (the analogue of skimage's compare_ssim at reference
    util_path_restore.py:27-44)."""
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    win = _gaussian_window(x.device)
    n, h, w, c = x.shape

    def filt(img):
        planes = img.permute(0, 3, 1, 2).reshape(n * c, 1, h, w)
        out = F.conv2d(planes, win)
        return out.reshape(n, c, *out.shape[2:])

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        mu_x, mu_y = filt(x), filt(y)
        sxx = filt(x * x) - mu_x ** 2
        syy = filt(y * y) - mu_y ** 2
        sxy = filt(x * y) - mu_x * mu_y
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    num = (2 * mu_x * mu_y + c1) * (2 * sxy + c2)
    den = (mu_x ** 2 + mu_y ** 2 + c1) * (sxx + syy + c2)
    return torch.mean(num / den, dim=(1, 2, 3))

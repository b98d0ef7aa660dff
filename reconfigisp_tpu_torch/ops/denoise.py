"""Spatial denoising ops (bilateral; median and fast NLM are not ported yet).

Counterpart of reconfigisp_tpu/ops/denoise.py.  `bilateral` is the kernel
module's dispatcher (ops/kernels/bilateral.py): a CUDA tensor goes to the
Hopper kernel, a CPU tensor to the plain PyTorch form; there is no size gate
and no switch.

bilateral params (N, 3): [window01, sigma_color01, sigma_space01];
window = 2*floor(window01*7)+3 in {3..15}, sigma = 1 + 99*sigma01 on the
0..255 intensity scale (reference tools_origin.py:673-717).
"""

from reconfigisp_tpu_torch.ops.kernels.bilateral import bilateral

__all__ = ["bilateral"]

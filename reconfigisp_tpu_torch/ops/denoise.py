"""Spatial denoising ops: bilateral, median and fast non-local means.

Counterpart of reconfigisp_tpu/ops/denoise.py.  Each op is its kernel
module's dispatcher (ops/kernels/): a CUDA tensor goes to the Hopper kernel,
a CPU tensor to the plain PyTorch form; there is no size gate and no switch.

Parameters in [0, 1], on the 0..255 intensity scale where a sigma or decay
is involved (reference tools_origin.py:673-804):
  bilateral (N, 3): [window01, sigma_color01, sigma_space01];
      window = 2*floor(window01*7)+3 in {3..15}, sigma = 1 + 99*sigma01.
  median (N, 1): [size01], window as above from params[0, 0] for the batch.
  fastnlm (N, 3): [block01, search01, decay01]; block from params[0, 0] for
      the batch, search per image, decay h = 1 + 99*decay01.
The dct_denoise BM3D stand-in is not ported yet (ROADMAP.md).
"""

from reconfigisp_tpu_torch.ops.kernels.bilateral import bilateral
from reconfigisp_tpu_torch.ops.kernels.fastnlm import fastnlm
from reconfigisp_tpu_torch.ops.kernels.median import median

__all__ = ["bilateral", "fastnlm", "median"]

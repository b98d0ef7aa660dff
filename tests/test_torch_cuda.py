"""The bilateral CUDA kernel against its plain PyTorch form, on the card.

Needs an NVIDIA GPU and nvcc; every test skips without a card.  The file
imports no JAX, so on a machine without JAX it runs alone:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from reconfigisp_tpu_torch.ops import denoise
from reconfigisp_tpu_torch.ops.kernels import bilateral as kb

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _case(shape, p, device):
    x = np.random.default_rng(31).uniform(0, 1, shape).astype(np.float32)
    return (torch.from_numpy(x).to(device),
            torch.as_tensor(np.asarray(p, np.float32), device=device))


_RADII = [[(r - 1 + 0.5) / 7.0, 0.1 * r, 0.05 + 0.1 * r] for r in range(1, 8)]


@pytest.mark.parametrize("shape,params", [
    ((7, 64, 96, 3), _RADII),                    # radii 1..7, distinct sigmas
    ((7, 40, 72, 1), _RADII),                    # one channel
    ((1, 520, 776, 3), [[0.5, 0.2, 0.3]]),       # no block size divides it
])
def test_kernel_matches_plain(cuda, shape, params):
    x, p = _case(shape, params, cuda)
    before = kb.launches
    got = kb.bilateral(x, p)
    torch.cuda.synchronize()
    assert kb.launches == before + 1
    want = kb.bilateral_plain(x, p)
    assert float((got - want).abs().max()) <= 2e-5


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x, p = _case((1, 16, 16, 3), [[0.5, 0.5, 0.5]], cuda)
    with pytest.raises(TypeError):
        kb.bilateral(x.double(), p)
    with pytest.raises(ValueError):
        kb.bilateral(x[:, :6], p)
    with pytest.raises(ValueError):
        kb.bilateral(torch.cat([x, x[..., :1]], -1), p)


def test_wrapper_copies_strided_input(cuda):
    """The kernel reads contiguous NHWC; a strided view and expanded params
    (as Pipeline passes them) are copied first, not refused."""
    x, p = _case((2, 16, 24, 3), [[0.5, 0.2, 0.3]], cuda)
    xt, pe = x.transpose(1, 2), p.expand(2, 3)
    got = kb.bilateral(xt, pe)
    want = kb.bilateral(xt.contiguous(), pe.contiguous())
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_op_refuses_grad_on_cuda(cuda):
    x, p = _case((1, 16, 16, 3), [[0.5, 0.5, 0.5]], cuda)
    with pytest.raises(RuntimeError, match="forward-only"):
        denoise.bilateral(x.requires_grad_(), p)

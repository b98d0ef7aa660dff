"""The bilateral filter's plain PyTorch form against the JAX forms: the jnp
tap loop, the op-level dispatch and the Pallas kernel in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reconfigisp_tpu.ops import denoise as jdenoise
from reconfigisp_tpu.ops.pallas_kernels import bilateral_pallas

from reconfigisp_tpu_torch import registry
from reconfigisp_tpu_torch.ops import denoise
from reconfigisp_tpu_torch.ops.kernels import bilateral as kb
from torch_one_thread import one_thread  # noqa: F401  (autouse)

# shape, params rows [window01, sigma_color01, sigma_space01]
_CASES = {
    "mixed_c3": ((2, 32, 32, 3), [[0.3, 0.2, 0.5], [0.9, 0.5, 0.1]]),
    "radius_1_and_7": ((2, 16, 24, 3), [[0.0, 0.3, 0.9], [1.0, 0.3, 0.9]]),
    "c1": ((2, 24, 16, 1), [[0.5, 0.3, 0.3], [0.99, 0.1, 0.7]]),
    "ragged_height": ((1, 40, 16, 3), [[0.6, 0.4, 0.2]]),  # 40 % 16 != 0
}

_REFS = {
    "jnp_loop": lambda x, p: jdenoise._bilateral_jnp(x, p),
    "op_dispatch": lambda x, p: jdenoise.bilateral(x, p),
    "pallas_interpret": lambda x, p: bilateral_pallas(x, p, strip=16,
                                                      interpret=True),
}


def _inputs(case):
    shape, p = _CASES[case]
    x = np.random.default_rng(11).uniform(0.05, 0.95, shape).astype(np.float32)
    return x, np.asarray(p, np.float32)


@pytest.mark.parametrize("ref", sorted(_REFS))
@pytest.mark.parametrize("case", sorted(_CASES))
def test_plain_matches_jax(case, ref):
    x, p = _inputs(case)
    want = _REFS[ref](jnp.asarray(x), jnp.asarray(p))
    got = kb.bilateral_plain(torch.from_numpy(x), torch.from_numpy(p))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_radius_mapping_matches_jax():
    p = np.linspace(0, 1, 29, dtype=np.float32)
    np.testing.assert_array_equal(
        kb.size01_to_radius(torch.from_numpy(p)).numpy(),
        np.asarray(jdenoise._size01_to_radius(jnp.asarray(p))))


def test_cpu_dispatch_uses_plain_form():
    """A CPU tensor takes the plain form and launches no kernel."""
    x, p = _inputs("mixed_c3")
    xt, pt = torch.from_numpy(x), torch.from_numpy(p)
    before = kb.launches
    out = denoise.bilateral(xt, pt)
    assert kb.launches == before
    assert torch.equal(out, kb.bilateral_plain(xt, pt))


def test_per_image_radius_smooths_more():
    x = np.random.default_rng(12).uniform(0.3, 0.7, (2, 16, 16, 1)).astype(
        np.float32)
    p = np.asarray([[0.0, 0.9, 0.9], [1.0, 0.9, 0.9]], np.float32)
    out = kb.bilateral_plain(torch.from_numpy(x), torch.from_numpy(p))
    assert out[1].std() < out[0].std()


def test_other_devices_raise():
    x = torch.empty((1, 16, 16, 3), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        kb.bilateral(x, torch.empty((1, 3), device="meta"))


def test_registry_routes_op7_to_bilateral():
    spec = registry.get_op("srgb", 7)
    assert (spec.name, spec.n_params) == ("bilateral", 3)
    assert denoise.bilateral is kb.bilateral
    x, p = _inputs("c1")
    xt, pt = torch.from_numpy(x), torch.from_numpy(p)
    assert torch.equal(spec.apply(xt, pt, None), kb.bilateral_plain(xt, pt))

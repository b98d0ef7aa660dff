"""Architecture strings -> executable ISP pipelines.

Counterpart of reconfigisp_tpu/pipeline.py.  The JAX Pipeline is stateless
and takes a state pytree; here the pipeline is an nn.Module that holds its
state: `logits` (one (P,) parameter per step that has parameters) and
`weights` (one learned module per op name, shared by the steps that use it).
`load_state` takes the state that convert.state_from_jax makes from a JAX
state.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from reconfigisp_tpu_torch.registry import OpSpec, get_op

_DOMAIN_TOKENS = {"Bayer": "bayer", "Demosaic": "demosaic", "sRGB": "srgb"}


def resolve_device(device=None) -> torch.device:
    """`cuda` unless the caller names a device; raises when CUDA is asked
    for and absent (the port never falls back to the CPU by itself)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def parse_architecture(arch: str):
    """"Bayer_01_Demosaic_03_sRGB_01_13_11" -> [(domain, 1-based index), ...]."""
    steps = []
    domain = None
    for token in arch.split("_"):
        if token in _DOMAIN_TOKENS:
            domain = _DOMAIN_TOKENS[token]
            continue
        if domain is None:
            raise ValueError(
                f"architecture {arch!r} must start with a domain token")
        steps.append((domain, int(token)))
    if not steps:
        raise ValueError(f"empty architecture {arch!r}")
    return steps


class Pipeline(nn.Module):
    """A fixed ISP pipeline of native ops.

    Pipeline(arch, device=None, generator=None): logits start at each op's
    init logits; learned modules are drawn from `generator` (a CPU
    torch.Generator, seeded 0 when not given).
    """

    def __init__(self, architecture: str, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.architecture = architecture
        self.steps = []
        for i, (domain, idx) in enumerate(parse_architecture(architecture)):
            spec = get_op(domain, idx)
            if spec.apply is None:
                raise NotImplementedError(
                    f"{domain} op {idx:02d} ({spec.name}) is not ported to "
                    f"PyTorch yet; ROADMAP.md lists what is still to port")
            self.steps.append((f"step{i + 1}_{spec.name}", spec))
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.logits = nn.ParameterDict()
        self.weights = nn.ModuleDict()
        for step_name, spec in self.steps:
            if spec.n_params:
                self.logits[step_name] = nn.Parameter(
                    torch.tensor(spec.init_logits, dtype=torch.float32))
            if spec.init_weights is not None and spec.name not in self.weights:
                self.weights[spec.name] = spec.init_weights(generator)
        self.device = dev
        self.to(dev)

    @torch.no_grad()
    def load_state(self, state: dict) -> "Pipeline":
        """Copy in {"logits": {step: (P,)}, "weights": {op: state_dict}};
        either part may be absent.  Unknown names raise KeyError."""
        for step, value in state.get("logits", {}).items():
            self.logits[step].copy_(value)
        for op, sd in state.get("weights", {}).items():
            self.weights[op].load_state_dict(sd)
        return self

    def forward(self, x: torch.Tensor, return_intermediates: bool = False):
        """x: (N, H, W, 1) Bayer (or partial-domain input) -> (N, H, W, 3) BGR.

        With return_intermediates, returns (y, {step_name: output},
        latency_ms_per_mp), the latency being None while any op's latency
        is not yet measured on the H100 (registry.LATENCY_MS_PER_MP).
        """
        n = x.shape[0]
        mids = {}
        for step_name, spec in self.steps:
            params = self._materialize_params(step_name, spec, n, x.dtype)
            weights = self.weights[spec.name] if spec.name in self.weights \
                else None
            x = spec.apply(x, params, weights)
            mids[step_name] = x
        if not return_intermediates:
            return x
        lat = [spec.latency for _, spec in self.steps]
        latency = None if None in lat else float(sum(lat))
        return x, mids, latency

    def _materialize_params(self, step_name: str, spec: OpSpec, n: int,
                            dtype: torch.dtype):
        if spec.n_params == 0:
            return None
        p01 = torch.sigmoid(self.logits[step_name]).to(dtype)
        return p01[None, :].expand(n, spec.n_params)


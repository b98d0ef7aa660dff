"""Architecture strings -> executable ISP pipelines.

Counterpart of reconfigisp_tpu/pipeline.py.  The JAX Pipeline is stateless
and takes a state pytree; here the pipeline is an nn.Module that holds its
state: `logits` (one (P,) parameter per step that has parameters; a
conditional op's is its raw flat FC vector) and `weights` (one learned
module per op name, shared by the steps that use it: the proxy where the
step runs its proxy; and one per step name for a step whose state carries
its own, which that step uses in place of its op's, as the JAX pipeline
looks a step's name up before its op's).  `load_state` takes the state that
convert.state_from_jax makes from a JAX state, or convert.state_from_bank
from the in-repo module bank.
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
    """A fixed ISP pipeline.

    Pipeline(arch, use_proxy=False, device=None, generator=None):
    use_proxy=False runs the native ops (bm3d, which has no native form,
    stays a proxy); use_proxy=True runs the CNN proxies where they exist.
    Logits start at each op's init logits; a conditional op's flat vector
    and the learned modules are drawn from `generator` (a CPU
    torch.Generator, seeded 0 when not given).
    """

    def __init__(self, architecture: str, use_proxy: bool = False, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.architecture = architecture
        self.use_proxy = use_proxy
        specs = [get_op(domain, idx)
                 for domain, idx in parse_architecture(architecture)]
        self.steps = [(f"step{i + 1}_{spec.name}", spec)
                      for i, spec in enumerate(specs)]
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.logits = nn.ParameterDict()
        self.weights = nn.ModuleDict()
        for step_name, spec in self.steps:
            if spec.conditional:
                self.logits[step_name] = nn.Parameter(
                    spec.init_params(generator))
            elif spec.n_params:
                self.logits[step_name] = nn.Parameter(
                    torch.tensor(spec.init_logits, dtype=torch.float32))
            init = spec.get_init(use_proxy)
            if init is not None and spec.name not in self.weights:
                self.weights[spec.name] = init(generator)
        self.device = dev
        self.to(dev)

    @torch.no_grad()
    def load_state(self, state: dict) -> "Pipeline":
        """Copy in {"logits": {step: (P,)}, "weights": {name: state_dict}};
        either part may be absent.  A weights name is an op's, or a step's
        (`step{i}_{op}`, as `steps` names them) whose step runs a learned
        module: that step then gets a module of its own.  Unknown names
        raise KeyError."""
        for step, value in state.get("logits", {}).items():
            self.logits[step].copy_(value)
        specs = dict(self.steps)
        for name, sd in state.get("weights", {}).items():
            if name not in self.weights and name in specs:
                init = specs[name].get_init(self.use_proxy)
                if init is None:
                    raise KeyError(f"step {name!r} runs no learned module")
                self.weights[name] = init(torch.Generator()).to(self.device)
            self.weights[name].load_state_dict(sd)
        return self

    def forward(self, x: torch.Tensor, return_intermediates: bool = False):
        """x: (N, H, W, 1) Bayer (or partial-domain input) -> (N, H, W, 3) BGR.

        With return_intermediates, returns (y, {step_name: output},
        latency_ms_per_mp), the sum of the steps' entries in
        registry.LATENCY_MS_PER_MP (None if one has none).
        """
        n = x.shape[0]
        mids = {}
        for step_name, spec in self.steps:
            params = self._materialize_params(step_name, spec, n, x.dtype)
            weights = next((self.weights[key] for key in (step_name, spec.name)
                            if key in self.weights), None)
            x = spec.get_apply(self.use_proxy)(x, params, weights)
            mids[step_name] = x
        if not return_intermediates:
            return x
        lat = [spec.latency for _, spec in self.steps]
        latency = None if None in lat else float(sum(lat))
        return x, mids, latency

    def _materialize_params(self, step_name: str, spec: OpSpec, n: int,
                            dtype: torch.dtype):
        if spec.conditional:
            return self.logits[step_name]
        if spec.n_params == 0:
            return None
        p01 = torch.sigmoid(self.logits[step_name]).to(dtype)
        return p01[None, :].expand(n, spec.n_params)


"""Op registry: the three candidate pools at the reference's 1-based indices.

Counterpart of reconfigisp_tpu/registry.py.  Every op of the Bayer (2),
demosaic (4) and sRGB (18) pools is listed with its parameter count and init
logits, so architecture strings index the same algorithms.  As in the JAX
package, an op has up to two forms:
  * native (`apply`), the default;
  * proxy (`proxy_apply`), a parameter-conditioned CNN: SRCNN-Res for the
    sRGB ops the JAX registry marks ft (2, 3, 4, 6, 7, 8, 9) and for bm3d
    (15), which is proxy-only; SRCNN demosaic for demosaic ops 2 and 3.
Learned weights are nn.Modules drawn from a torch.Generator.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from reconfigisp_tpu_torch.ops import (
    cnn, color, conditional, demosaic, denoise, tone)

# Per-op latency in ms per megapixel, for the latency-aware loss and the
# supernet's expected latency: measured by utils/latency.calibrate(size=1024,
# batch=1) on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit, native ops
# (bm3d is its proxy), kernels on, TF32 off; that call on the card measures
# it again.
# utils/latency.install replaces it with a table measured elsewhere; a None
# entry leaves the latency undefined (the JAX package's table was measured
# on a TPU and does not carry over).
LATENCY_MS_PER_MP = {
    "skip": 0.008270,
    "gamma": 0.102661,
    "grayworld": 0.083862,
    "wbmanual": 0.039001,
    "whiteworld": 0.443237,
    "wbquadratic": 0.605621,
    "gtmmanual": 0.211456,
    "reinhard": 0.447632,
    "crysisengine": 0.074768,
    "filmic": 0.228699,
    "bilateral": 0.112854,
    "median": 0.135864,
    "fastnlm": 0.371185,
    "nearest": 0.757782,
    "bilinear": 0.564484,
    "laplacian": 1.016144,
    "demosaicnet": 1.219208,
    "path_bayer": 7.613251,
    "path_bgr": 29.717559,
    "bm3d": 14.210419,
    "conditional_gamma": 0.459595,
    "conditional_wb_manual": 0.355438,
    "conditional_wb_quadratic": 1.595093,
}


@dataclasses.dataclass(frozen=True)
class OpSpec:
    name: str
    domain: str                      # 'bayer' | 'demosaic' | 'srgb'
    n_params: int
    init_logits: tuple               # default logits; sigmoid -> [0,1] params
    apply: Optional[Callable]        # native apply(x, params, weights)
    init_weights: Optional[Callable] = None  # torch.Generator -> nn.Module
    proxy_apply: Optional[Callable] = None   # proxy apply(x, params, weights)
    proxy_init: Optional[Callable] = None    # torch.Generator -> nn.Module
    conditional: bool = False        # raw flat params, no sigmoid/repeat
    init_params: Optional[Callable] = None   # generator -> logits (conditional)
    ft_target: bool = False          # its proxy is tuned online (DartsFtTrainer)
    ft_target_apply: Optional[Callable] = None  # the proxy's target where it
                                                # is not `apply` (bm3d)

    @property
    def latency(self) -> Optional[float]:
        return LATENCY_MS_PER_MP[self.name]

    @property
    def proxy_only(self) -> bool:
        return self.apply is None

    def ft_target_fn(self) -> Optional[Callable]:
        """The function the proxy imitates in proxy tuning: the native form,
        or `ft_target_apply` where there is none (bm3d)."""
        if self.ft_target_apply is not None:
            return self.ft_target_apply
        return self.apply

    def get_init(self, use_proxy: bool) -> Optional[Callable]:
        """The constructor of the module that get_apply(use_proxy) runs
        with, or None."""
        if (use_proxy or self.apply is None) and self.proxy_init is not None:
            return self.proxy_init
        return self.init_weights

    def get_apply(self, use_proxy: bool) -> Callable:
        """The proxy where asked for (or where no native form exists) and
        one exists; the native form otherwise."""
        if (use_proxy or self.apply is None) and self.proxy_apply is not None:
            return self.proxy_apply
        return self.apply


_WBQ_INIT = (0, 0, 0, 0, 0, 0, 0.406, 0, 0, 0,
             0, 0, 0, 0, 0, 0, 0, 0.406, 0, 0,
             0, 0, 0, 0, 0, 0, 0, 0, 0.406, 0)  # identity diag, sigmoid->0.6->coef 1


def _srcnn_proxy(n_params: int) -> dict:
    """An SRCNN-Res proxy, tuned online against the op's target."""
    return {"proxy_apply": lambda x, p, w: cnn.apply_srcnn_res(w, x, p),
            "proxy_init": lambda g: cnn.SRCNNRes(n_params, g),
            "ft_target": True}


_DEMOSAIC_PROXY = {
    "proxy_apply": lambda x, p, w: cnn.apply_srcnn_demosaic(w, x),
    "proxy_init": cnn.SRCNNDemosaic}


def _conditional_init(n_global: int, base_logits: tuple):
    """The FC weights ~ N(0, 0.01^2), then the base op's init logits as the
    global part (reference isp_universal.py:185-190)."""
    total = conditional.conditional_n_params(
        conditional.DEFAULT_IN_CHANNELS, n_global)

    def init(generator: torch.Generator) -> torch.Tensor:
        w = 0.01 * torch.randn(total - n_global, generator=generator)
        return torch.cat([w, torch.tensor(base_logits, dtype=torch.float32)])

    return init


def _build_registry():
    reg = {"bayer": {}, "demosaic": {}, "srgb": {}}

    def add(domain, idx, name, n_params=0, init_logits=(), apply=None, **kw):
        reg[domain][name] = (idx, OpSpec(name, domain, n_params,
                                         tuple(init_logits), apply, **kw))

    add("bayer", 1, "path_bayer",
        apply=lambda x, p, w: cnn.apply_path14_bayer(w, x),
        init_weights=cnn.path14_bayer)
    add("bayer", 2, "skip", apply=color.skip)

    add("demosaic", 1, "nearest", apply=demosaic.demosaic_nearest)
    add("demosaic", 2, "bilinear", apply=demosaic.demosaic_bilinear,
        **_DEMOSAIC_PROXY)
    add("demosaic", 3, "laplacian", apply=demosaic.demosaic_malvar,
        **_DEMOSAIC_PROXY)
    add("demosaic", 4, "demosaicnet",
        apply=lambda x, p, w: cnn.apply_srcnn_demosaic(w, x),
        init_weights=cnn.SRCNNDemosaic)

    add("srgb", 1, "gamma", 1, (0.,), color.gamma)
    add("srgb", 2, "reinhard", 2, (0., 0.), tone.tone_reinhard,
        **_srcnn_proxy(2))
    add("srgb", 3, "crysisengine", 1, (0.,), tone.tone_crysis,
        **_srcnn_proxy(1))
    add("srgb", 4, "filmic", 2, (0., 0.), tone.tone_filmic,
        **_srcnn_proxy(2))
    add("srgb", 5, "grayworld", apply=color.grayworld)
    add("srgb", 6, "whiteworld", 1, (0.,), color.wb_whiteworld,
        **_srcnn_proxy(1))
    add("srgb", 7, "bilateral", 3, (0., 0., 0.),
        lambda x, p, w: denoise.bilateral(x, p), **_srcnn_proxy(3))
    add("srgb", 8, "median", 1, (0.,),
        lambda x, p, w: denoise.median(x, p), **_srcnn_proxy(1))
    add("srgb", 9, "fastnlm", 3, (0., 0., 0.),
        lambda x, p, w: denoise.fastnlm(x, p), **_srcnn_proxy(3))
    add("srgb", 10, "skip", apply=color.skip)
    add("srgb", 11, "wbmanual", 3, (-1.38, -1.38, -1.38), color.wb_manual)
    add("srgb", 12, "path_bgr",
        apply=lambda x, p, w: cnn.apply_path14_bgr(w, x),
        init_weights=cnn.path14_bgr)
    add("srgb", 13, "wbquadratic", 30, _WBQ_INIT, color.wb_quadratic)
    add("srgb", 14, "gtmmanual", 3, (-1.099, 0., 1.099), tone.gtm_manual)
    # BM3D: proxy-only, as in the JAX package; its proxy's training target is
    # the transform-domain stand-in dct_denoise
    add("srgb", 15, "bm3d", 5, (-1.946, 1.099, -1.099, -1.099, 2.708),
        ft_target_apply=denoise.dct_denoise, **_srcnn_proxy(5))
    # conditional ops: a flat FC-net parameter vector (418/454/940 values)
    for idx, name, n_glob, base, apply in (
            (16, "conditional_gamma", 1, (0.,),
             conditional.conditional_gamma),
            (17, "conditional_wb_manual", 3, (-1.38, -1.38, -1.38),
             conditional.conditional_wb_manual),
            (18, "conditional_wb_quadratic", 30, _WBQ_INIT,
             conditional.conditional_wb_quadratic)):
        total = conditional.conditional_n_params(
            conditional.DEFAULT_IN_CHANNELS, n_glob)
        add("srgb", idx, name, total, apply=apply, conditional=True,
            init_params=_conditional_init(n_glob, base))
    return reg


_REGISTRY = _build_registry()


def get_op(domain: str, name_or_index) -> OpSpec:
    dom = _REGISTRY[domain]
    if isinstance(name_or_index, int):
        for idx, spec in dom.values():
            if idx == name_or_index:
                return spec
        raise KeyError(f"no op with index {name_or_index} in domain {domain}")
    return dom[name_or_index][1]


def pool(domain: str):
    """Ordered list of OpSpecs for a domain (1-based reference order)."""
    return [spec for _, spec in sorted(_REGISTRY[domain].values(),
                                       key=lambda t: t[0])]



def op_index(domain: str, name: str) -> int:
    return _REGISTRY[domain][name][0]


# The supernet's sRGB slots hold ops 1..15 (reference super_prune...py:101-118);
# the conditional ops 16-18 serve fixed pipelines only.
SUPERNET_SRGB_COUNT = 15

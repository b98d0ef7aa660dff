"""Op registry: the three candidate pools at the reference's 1-based indices.

Counterpart of reconfigisp_tpu/registry.py:122-240.  Every op of the Bayer
(2), demosaic (4) and sRGB (18) pools is listed with its parameter count and
init logits, so architecture strings index the same algorithms.  Only ported
ops carry an `apply`; building a pipeline with any other op raises
NotImplementedError (the queue of what is still to port is in ROADMAP.md).
The CNN proxies are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from reconfigisp_tpu_torch.ops import cnn, color, demosaic, denoise

# Per-op latency in ms per megapixel on the H100, for the latency-aware loss.
# Every entry is None: not yet measured on the H100 (the JAX package's table
# was measured on a TPU and does not carry over).
LATENCY_MS_PER_MP = {name: None for name in (
    "skip", "gamma", "grayworld", "wbmanual", "whiteworld", "wbquadratic",
    "gtmmanual", "reinhard", "crysisengine", "filmic", "bilateral", "median",
    "fastnlm", "nearest", "bilinear", "laplacian", "demosaicnet",
    "path_bayer", "path_bgr", "bm3d", "conditional_gamma",
    "conditional_wb_manual", "conditional_wb_quadratic")}


@dataclasses.dataclass(frozen=True)
class OpSpec:
    name: str
    domain: str                      # 'bayer' | 'demosaic' | 'srgb'
    n_params: int
    init_logits: tuple               # default logits; sigmoid -> [0,1] params
    apply: Optional[Callable]        # apply(x, params, weights); None: not ported
    init_weights: Optional[Callable] = None  # torch.Generator -> nn.Module
    conditional: bool = False        # raw flat params, no sigmoid/repeat

    @property
    def latency(self) -> Optional[float]:
        return LATENCY_MS_PER_MP[self.name]


_WBQ_INIT = (0, 0, 0, 0, 0, 0, 0.406, 0, 0, 0,
             0, 0, 0, 0, 0, 0, 0, 0.406, 0, 0,
             0, 0, 0, 0, 0, 0, 0, 0, 0.406, 0)  # identity diag, sigmoid->0.6->coef 1


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
    add("demosaic", 2, "bilinear", apply=demosaic.demosaic_bilinear)
    add("demosaic", 3, "laplacian", apply=demosaic.demosaic_malvar)
    add("demosaic", 4, "demosaicnet")

    add("srgb", 1, "gamma", 1, (0.,), color.gamma)
    add("srgb", 2, "reinhard", 2, (0., 0.))
    add("srgb", 3, "crysisengine", 1, (0.,))
    add("srgb", 4, "filmic", 2, (0., 0.))
    add("srgb", 5, "grayworld", apply=color.grayworld)
    add("srgb", 6, "whiteworld", 1, (0.,), color.wb_whiteworld)
    add("srgb", 7, "bilateral", 3, (0., 0., 0.),
        lambda x, p, w: denoise.bilateral(x, p))
    add("srgb", 8, "median", 1, (0.,))
    add("srgb", 9, "fastnlm", 3, (0., 0., 0.))
    add("srgb", 10, "skip", apply=color.skip)
    add("srgb", 11, "wbmanual", 3, (-1.38, -1.38, -1.38), color.wb_manual)
    add("srgb", 12, "path_bgr",
        apply=lambda x, p, w: cnn.apply_path14_bgr(w, x),
        init_weights=cnn.path14_bgr)
    add("srgb", 13, "wbquadratic", 30, _WBQ_INIT, color.wb_quadratic)
    add("srgb", 14, "gtmmanual", 3, (-1.099, 0., 1.099))
    add("srgb", 15, "bm3d", 5, (-1.946, 1.099, -1.099, -1.099, 2.708))
    # conditional ops: a flat FC-net parameter vector (418/454/940 values)
    for idx, name, total in ((16, "conditional_gamma", 418),
                             (17, "conditional_wb_manual", 454),
                             (18, "conditional_wb_quadratic", 940)):
        add("srgb", idx, name, total, conditional=True)
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


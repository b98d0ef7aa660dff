"""The search space of SID_search.yaml, as the method defines it.

The supernet's slots: a Bayer slot of 2 candidates, a demosaic slot of 4 and
n_step sRGB slots of the first 15 sRGB ops (reference
super_prune_fifteen_demos_four_bayer_two.py), each op with its parameter
count, its initial logits and its learned module, if any.  Under proxy
search the ops in PROXIED run their CNN proxy (SRCNN-Res for the sRGB ops,
the SRCNN demosaic for the two demosaics); bm3d has no native form and is
always its proxy.
"""

from __future__ import annotations

BAYER = ("path_bayer", "skip")
DEMOSAIC = ("nearest", "bilinear", "laplacian", "demosaicnet")
SRGB = ("gamma", "reinhard", "crysisengine", "filmic", "grayworld",
        "whiteworld", "bilateral", "median", "fastnlm", "skip", "wbmanual",
        "path_bgr", "wbquadratic", "gtmmanual", "bm3d")

_WBQ = (0, 0, 0, 0, 0, 0, 0.406, 0, 0, 0,
        0, 0, 0, 0, 0, 0, 0, 0.406, 0, 0,
        0, 0, 0, 0, 0, 0, 0, 0, 0.406, 0)

# op -> initial logits (their count is the op's parameter count)
INIT_LOGITS = {
    "gamma": (0.,), "reinhard": (0., 0.), "crysisengine": (0.,),
    "filmic": (0., 0.), "whiteworld": (0.,), "bilateral": (0., 0., 0.),
    "median": (0.,), "fastnlm": (0., 0., 0.), "wbmanual": (-1.38,) * 3,
    "wbquadratic": _WBQ, "gtmmanual": (-1.099, 0., 1.099),
    "bm3d": (-1.946, 1.099, -1.099, -1.099, 2.708),
}

PROXIED = ("bilinear", "laplacian", "reinhard", "crysisengine", "filmic",
           "whiteworld", "bilateral", "median", "fastnlm", "bm3d")
ALWAYS_PROXY = ("bm3d",)


POOLS = {"Bayer": BAYER, "Demosaic": DEMOSAIC, "sRGB": SRGB}


def parse(architecture: str) -> list:
    """"Bayer_01_Demosaic_03_sRGB_01_13_11" -> the op names in order
    (1-based indices into each domain's pool)."""
    steps, pool = [], None
    for token in architecture.split("_"):
        if token in POOLS:
            pool = POOLS[token]
        else:
            steps.append(pool[int(token) - 1])
    return steps


def slots(n_step: int) -> list:
    """[(slot name, candidate op names)] in the supernet's order."""
    return ([("bayer", BAYER), ("demosaic", DEMOSAIC)]
            + [(f"step{k + 1}", SRGB) for k in range(n_step)])


def runs_proxy(op: str, use_proxies: bool) -> bool:
    return op in ALWAYS_PROXY or (use_proxies and op in PROXIED)


def module_kind(op: str, use_proxies: bool):
    """'path_bayer', 'path_bgr', 'srcnn_demosaic', 'srcnn_res' or None: the
    learned module the op runs with."""
    if op in ("path_bayer", "path_bgr"):
        return op
    if op == "demosaicnet" or (op in DEMOSAIC and runs_proxy(op, use_proxies)):
        return "srcnn_demosaic"
    if runs_proxy(op, use_proxies):
        return "srcnn_res"
    return None


def conv_shapes(kind: str) -> list:
    """[(in channels, out channels, kernel)] of a module's convolutions."""
    if kind in ("path_bayer", "path_bgr"):
        c = 4 if kind == "path_bayer" else 3
        return [(c, 64, 3)] + [(64, 64, 3)] * 12 + [(64, c, 3)]
    if kind == "srcnn_demosaic":
        return [(4, 64, 9), (64, 32, 1), (32, 12, 5)]
    if kind == "srcnn_res":
        return [(3 + 9 + 5, 64, 9), (64, 32, 5), (32, 3, 5)]
    raise ValueError(kind)


def modules(n_step: int, use_proxies: bool) -> dict:
    """op -> module kind, for every op of the space that runs one."""
    out = {}
    for _, ops in slots(n_step):
        for op in ops:
            kind = module_kind(op, use_proxies)
            if kind is not None:
                out[op] = kind
    return out

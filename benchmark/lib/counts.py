"""The work a cell asks of the chip, counted from its shapes, and the chip's
published peaks.

Counts are of the model's arithmetic, whatever implements it: a
convolution is 2 cin cout k^2 operations per output position; elementwise
stages count the operations their formulas need per value; nothing counts
recomputation (remat) or padding.  The kernels' bounds are the benchmark's
frozen copy of the roofline counts of the three hand kernels (bilateral,
median, fast non-local means).
"""

from __future__ import annotations

from benchmark.reference import zoo

# NVIDIA H100 SXM data sheet, dense: float32 outside the tensor cores,
# bfloat16 on them; HBM3 bandwidth; exp on the special-function units: 16
# per clock per SM (compute capability 9.0) x 132 SMs x 1.98 GHz.
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12}
HBM_BYTES_PER_S = 3.35e12
SFU_EXP_PER_S = 16 * 132 * 1.98e9

# Operations per value (per pixel and channel, or per pixel where said) of
# the elementwise stages.
DEMOSAIC_PER_PIXEL = 40        # Malvar: two stencils of 9-11 taps, FMA each
WBQ_PER_PIXEL = 66             # 6 products, 3 channels x 10 FMAs
ELEMENTWISE_PER_VALUE = {"gamma": 3, "wbmanual": 2, "reinhard": 20,
                         "crysisengine": 4, "filmic": 20, "grayworld": 3,
                         "whiteworld": 4, "gtmmanual": 8, "skip": 0}
BLEND_PER_PIXEL = 7            # mask times 3 channels, 3 adds, 1 count add


def conv_flops(shapes, positions: int) -> int:
    return sum(2 * cin * cout * k * k for cin, cout, k in shapes) * positions


def frame_tiles(h: int, w: int, patch: int, stride: int) -> int:
    def count(total):
        return len(range(0, total - patch, stride)) + 1
    return count(h) * count(w)


def op_flops(op: str, n: int, h: int, w: int, use_proxies: bool,
             radii: dict) -> float:
    """One forward of an op on n images of h x w.  radii: {op: (window
    radius, block radius)} of the windowed ops."""
    kind = zoo.module_kind(op, use_proxies)
    px = n * h * w
    if kind in ("path_bayer", "srcnn_demosaic"):
        return conv_flops(zoo.conv_shapes(kind), px // 4)
    if kind in ("path_bgr", "srcnn_res"):
        return conv_flops(zoo.conv_shapes(kind), px)
    if op in ("nearest", "bilinear", "laplacian"):
        return DEMOSAIC_PER_PIXEL * px
    if op == "wbquadratic":
        return WBQ_PER_PIXEL * px
    if op in ("bilateral", "median", "fastnlm"):
        flops, exps = WINDOWED[op]((n, h, w, 3), *radii[op])
        return flops + exps
    return ELEMENTWISE_PER_VALUE[op] * px * 3


def serve_frame_flops(architecture: str, h: int, w: int, patch: int,
                      stride: int, radii: dict | None = None) -> float:
    """A frame served tile by tile: every tile's pipeline, and the blend."""
    tiles = frame_tiles(h, w, patch, stride)
    per_tile = sum(op_flops(op, 1, patch, patch, False, radii or {})
                   for op in zoo.parse(architecture))
    return tiles * (per_tile + BLEND_PER_PIXEL * patch * patch) + 3 * h * w


PASSES = 5   # forward passes of a second-order DARTS step


def supernet_forward_flops(n_step: int, use_proxies: bool, n: int, h: int,
                           w: int, radii: dict) -> float:
    """One forward over every slot's candidates.  radii: {slot: {op:
    (window radius, block radius)}} of the windowed ops."""
    return sum(op_flops(op, n, h, w, use_proxies, radii.get(slot, {}))
               for slot, ops in zoo.slots(n_step) for op in ops)


def search_step_flops(n_step: int, use_proxies: bool, n: int, crop: int,
                      radii: dict) -> float:
    """A second-order step: five passes, each a forward over every
    candidate and a backward to the inputs (omega is frozen, so no weight
    gradients: one forward's worth)."""
    return PASSES * 2 * supernet_forward_flops(n_step, use_proxies, n, crop,
                                               crop, radii)


def search_step_windowed(n_step: int, use_proxies: bool, n: int, crop: int,
                         radii: dict) -> dict:
    """{op: [(input shape, window radius, block radius)]}: the forward
    applications of the windowed ops (those not run by a proxy) that a
    second-order step needs, each pass applying each slot's candidates once
    to the batch, however the program groups them into launches."""
    out: dict = {}
    for slot, ops in zoo.slots(n_step):
        for op in ops:
            if op in WINDOWED and zoo.module_kind(op, use_proxies) is None:
                r, block = radii[slot][op]
                out.setdefault(op, []).extend(
                    [((n, crop, crop, 3), r, block)] * PASSES)
    return out


# ----------------------------------------------------- the kernels' bounds

def _bound_s(moved_bytes: float, flops: float, exps: float) -> float:
    return max(moved_bytes / HBM_BYTES_PER_S,
               flops / PEAK_FLOPS["f32"], exps / SFU_EXP_PER_S)


def bilateral_ops(shape, r: int, _block: int = 0):
    """(FP32 operations, exps) of a bilateral of window radius r: the colour
    weight is symmetric and 1 at the centre, so ((2r+1)^2 - 1) / 2 distinct
    exps per value, 3 operations for each argument, and 4 per tap (the
    weights' product, an FMA into the numerator, an add into the
    denominator)."""
    n, h, w, c = shape
    taps = (2 * r + 1) ** 2 * n * h * w * c
    exps = ((2 * r + 1) ** 2 - 1) // 2 * n * h * w * c
    return 4 * taps + 3 * exps, exps


def median_ops(shape, r: int, _block: int = 0):
    """K - 1 comparisons per value, K = (2r+1)^2 taps."""
    n, h, w, c = shape
    return ((2 * r + 1) ** 2 - 1) * n * h * w * c, 0


def fastnlm_ops(shape, s: int, _block: int = 0):
    """((2s+1)^2 - 1) / 2 distinct offsets per value (D_o at p is D_-o at
    p + o), each 14 operations (difference and square 2, running box sums
    5, the exp's argument 1, two pixels' numerators and denominators 6) and
    one exp."""
    n, h, w, c = shape
    distinct = ((2 * s + 1) ** 2 - 1) // 2 * n * h * w * c
    return 14 * distinct, distinct


WINDOWED = {"bilateral": bilateral_ops, "median": median_ops,
            "fastnlm": fastnlm_ops}


def kernel_bound_s(op: str, shape, r: int, block: int = 0) -> float:
    """Least seconds for one launch on these inputs: each input value read
    and each output written once (float32), or the operations at their
    peaks, whichever is longer."""
    n, h, w, c = shape
    n_params = {"bilateral": 3, "median": 1, "fastnlm": 3}[op]
    moved = 2 * n * h * w * c * 4 + n * n_params * 4
    flops, exps = WINDOWED[op](shape, r, block)
    return _bound_s(moved, flops, exps)

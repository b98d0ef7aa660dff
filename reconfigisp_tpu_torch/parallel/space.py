"""The mesh's space axis on whole frames: windows with a halo.

Counterpart of XLA's SPMD partitioning of image height over the JAX mesh's
"space" axis (reconfigisp_tpu/parallel/mesh.py:41-61, dp.py:89-108), which
inserts halo exchanges for the stencils and cross-shard reductions for the
global statistics.  Every rank of the port already holds the whole global
batch, so no halo is exchanged: under JAX's NamedSharding rule rank
(d, s) owns rows [s H/S, (s+1) H/S) of each frame, and it runs the network
on a *window* of those rows and a halo of the network's row radius on each
side (`window`), then keeps its owned rows (`trim`).  The window's bounds
are rounded outward to even rows, so that the RGGB phase and the
half-resolution pack of the Bayer ops hold, and clipped to the frame, so
that each op's own padding falls only at the frame's top and bottom; every
rank's window has one height (at the frame's edges it is shifted inwards),
so one exported program, one cuDNN plan and one captured shape serve every
rank, and the trim is the only thing that differs.  Where the window would
exceed the frame, the whole frame is the window.

The row radius of an op is how far a wrong row at a window edge reaches
into its output: `RADIUS`, from each op's code.  A pipeline's radius is the
sum of its steps', a supernet slot's the largest of its candidates' in the
form the net runs (`radius`).

The global ops (grayworld's means, whiteworld's quantile, reinhard's
log-average, the conditional ops' histograms and the SRCNN proxies'
min/mean/max) reduce over the whole frame.  Under a space context
(`context`, set around a call: the space group, the rank's window and the
frame's height) they take their statistic over the owned rows and reduce
it over the space group through two torch.library custom ops, which
torch.export carries into a serving program and which read the context
when the program runs:
  * reconfigisp::space_sum(x): the sum of x over the frame's rows (dim 1):
    over the owned rows, SUM-reduced over the group; its gradient is the
    SUM all-reduce of the incoming gradient, on the owned rows;
  * reconfigisp::space_rows(x, reduce_grad): the owned rows gathered over
    the group in rank order, the frame's rows; its gradient is the incoming
    one's owned rows, SUM-reduced over the group first where reduce_grad
    (a statistic each rank uses in its own rows) and not where every rank
    computes the same function of the gathered frame (the criterion).
Without a context the ops are not called: the single-device path is what
it was.  A one-rank context (group None, the window the frame) makes both
the identity on the frame.  Under gloo, CUDA tensors go through host
copies (parallel/mesh.collective).  A failed collective raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch

from reconfigisp_tpu_torch.ops.kernels import bilateral, fastnlm, median
from reconfigisp_tpu_torch.parallel import mesh as meshlib

ALIGN = 2   # window bounds on even rows: the RGGB phase

# Row radii of the learned nets, from ops/cnn.py: "same" convolutions, k // 2
# rows each; the Bayer-domain nets run on the RGGB planes at half resolution,
# where one row is two mosaic rows (windows start on even rows).
PATH14_RADIUS = 1 + 2 * 6 + 1        # conv_first, six blocks of two, conv_last
SRCNN_RES_RADIUS = 4 + 2 + 2         # 9x9, 5x5, 5x5
SRCNN_DEMOSAIC_RADIUS = 2 * (4 + 0 + 2)   # 9x9, 1x1, 5x5 on the RGGB planes
DEMOSAIC_RADIUS = 2                  # ops/demosaic.py: 5x5 stencil banks
DCT_DENOISE_RADIUS = 8               # ops/denoise.dct_denoise: blocks of <= 8

# op name -> (native form's radius, proxy's radius or None).  bm3d has no
# native form; its proxy's tuning target dct_denoise runs on whole frames
# only (the ft trainer's replay memory), and its 4 half-block covers need a
# window start on a multiple of 4 besides DCT_DENOISE_RADIUS.
RADIUS = {
    "path_bayer": (2 * PATH14_RADIUS, None),
    "skip": (0, None),
    "nearest": (DEMOSAIC_RADIUS, None),
    "bilinear": (DEMOSAIC_RADIUS, SRCNN_DEMOSAIC_RADIUS),
    "laplacian": (DEMOSAIC_RADIUS, SRCNN_DEMOSAIC_RADIUS),
    "demosaicnet": (SRCNN_DEMOSAIC_RADIUS, None),
    "gamma": (0, None),
    "reinhard": (0, SRCNN_RES_RADIUS),
    "crysisengine": (0, SRCNN_RES_RADIUS),
    "filmic": (0, SRCNN_RES_RADIUS),
    "grayworld": (0, None),
    "whiteworld": (0, SRCNN_RES_RADIUS),
    "bilateral": (bilateral.HALO, SRCNN_RES_RADIUS),
    "median": (median.HALO, SRCNN_RES_RADIUS),
    "fastnlm": (fastnlm.HALO, SRCNN_RES_RADIUS),
    "wbmanual": (0, None),
    "path_bgr": (PATH14_RADIUS, None),
    "wbquadratic": (0, None),
    "gtmmanual": (0, None),
    "bm3d": (None, SRCNN_RES_RADIUS),
    "conditional_gamma": (0, None),
    "conditional_wb_manual": (0, None),
    "conditional_wb_quadratic": (0, None),
}


def op_radius(spec, use_proxy: bool) -> int:
    """The row radius of the form of `spec` (a registry.OpSpec) that
    spec.get_apply(use_proxy) runs."""
    native, proxy = RADIUS[spec.name]
    if (use_proxy or spec.apply is None) and spec.proxy_apply is not None:
        return proxy
    return native


def radius(net) -> int:
    """A Pipeline's row radius (the sum of its steps'), or a SuperNet's
    (the sum over its slots of the largest candidate's)."""
    if hasattr(net, "slots"):
        return sum(max(op_radius(s, net.use_proxies) for s in ops)
                   for _, ops in net.slots)
    return sum(op_radius(spec, net.use_proxy) for _, spec in net.steps)


# ------------------------------------------------------------------ windows

@dataclasses.dataclass(frozen=True)
class Window:
    """Frame rows [start, stop) that a rank computes, and [own_start,
    own_stop) among them that it owns."""
    start: int
    stop: int
    own_start: int
    own_stop: int

    @property
    def rows(self) -> int:
        return self.stop - self.start

    @property
    def trim(self) -> slice:
        """The owned rows within the window."""
        return slice(self.own_start - self.start, self.own_stop - self.start)


def _owned(height: int, index: int, size: int) -> tuple:
    if height % size:
        raise ValueError(f"a frame of {height} rows does not split over "
                         f"{size} space ranks")
    part = height // size
    return index * part, (index + 1) * part


def _reach(height: int, index: int, size: int, halo: int) -> tuple:
    """The owned rows and a halo on each side, rounded outward to ALIGN
    rows and clipped to the frame."""
    lo, hi = _owned(height, index, size)
    lo = max(0, (lo - halo) // ALIGN * ALIGN)
    hi = min(height, -(-(hi + halo) // ALIGN) * ALIGN)
    return lo, hi


def window_rows(height: int, size: int, halo: int) -> int:
    """The common window height of `size` space ranks: the widest rank's
    reach, or the frame (an odd frame is not split)."""
    if height % ALIGN:
        return height
    return max(hi - lo for lo, hi in (_reach(height, s, size, halo)
                                      for s in range(size)))


def window(height: int, index: int, size: int, halo: int) -> Window:
    """Rank `index` of `size` space ranks on a frame of `height` rows, for
    a network of row radius `halo`: its owned rows (JAX's NamedSharding
    rule; a height the ranks do not divide raises ValueError) and its
    window of window_rows(...) rows that holds them with `halo` rows on
    each side (fewer at the frame's edges), starting on an even row and
    shifted inwards where it would leave the frame."""
    own = _owned(height, index, size)
    rows = window_rows(height, size, halo)
    start = min(_reach(height, index, size, halo)[0], height - rows)
    return Window(start, start + rows, *own)


# ------------------------------------------------------------------ context

@dataclasses.dataclass(frozen=True)
class Context:
    group: object      # the space group; None for one rank
    window: Window
    frame: int         # the frame's height


_context: Optional[Context] = None


@contextlib.contextmanager
def context(group, win: Window, frame: int):
    """Within the block the global ops reduce over `group` (None: one
    rank) and the pipeline and supernet trim their intermediates to the
    window's owned rows.  The context is the process's, not the thread's,
    so autograd's device thread sees it in a backward."""
    global _context
    outer, _context = _context, Context(group, win, frame)
    try:
        yield _context
    finally:
        _context = outer


def active() -> bool:
    return _context is not None


def frame_height() -> int:
    return _context.frame


def trim(y: torch.Tensor) -> torch.Tensor:
    """The owned rows of a window-shaped tensor (dim 1)."""
    return y[:, _context.window.trim]


def whole_frame(height: int):
    """A one-rank context over a frame: the reductions are the identity
    (tests, and the trace of a space-parallel program, where only the
    frame's height is read)."""
    return context(None, Window(0, height, 0, height), height)


class SpaceAxis:
    """This rank's part of a mesh's space axis, for a network of row
    radius `halo` (None: the whole frame is every rank's window)."""

    def __init__(self, group, index: int, size: int, halo: Optional[int]):
        self.group, self.index, self.size = group, index, size
        self.halo = halo

    @classmethod
    def of(cls, mesh, halo: Optional[int]) -> Optional["SpaceAxis"]:
        """The mesh's space axis; None without a mesh or with space 1."""
        if mesh is None or mesh.size(1) == 1:
            return None
        return cls(mesh.get_group(meshlib.SPACE_AXIS),
                   mesh.get_local_rank(meshlib.SPACE_AXIS), mesh.size(1),
                   halo)

    def window(self, height: int) -> Window:
        return window(height, self.index, self.size,
                      height if self.halo is None else self.halo)

    @contextlib.contextmanager
    def frame(self, height: int):
        """The context of this rank on frames of `height` rows."""
        with context(self.group, self.window(height), height) as ctx:
            yield ctx.window

    @staticmethod
    def take(x: torch.Tensor) -> torch.Tensor:
        """The current window's rows of a whole frame (dim 1)."""
        win = _context.window
        if x.shape[1] != _context.frame:
            raise ValueError(f"a frame of {x.shape[1]} rows under a context "
                             f"of {_context.frame}")
        return x[:, win.start:win.stop]


# ------------------------------------------------------- the collectives

def _unsqueeze_rows(g: torch.Tensor, rows: int, win: slice) -> torch.Tensor:
    out = g.new_zeros((g.shape[0], rows) + tuple(g.shape[1:]))
    out[:, win] = g.unsqueeze(1)
    return out


@torch.library.custom_op("reconfigisp::space_sum", mutates_args=())
def frame_sum(x: torch.Tensor) -> torch.Tensor:
    """(N, rows, ...) -> (N, ...): the frame's rows summed (module
    docstring); x.sum(1) without a context."""
    ctx = _context
    if ctx is None:
        return x.sum(1)
    out = x[:, ctx.window.trim].sum(1)
    if ctx.group is not None:
        meshlib.all_reduce(out, ctx.group)
    return out


@frame_sum.register_fake
def _(x):
    return x.new_empty((x.shape[0],) + tuple(x.shape[2:]))


def _sum_setup(ctx, inputs, output):
    ctx.rows = inputs[0].shape[1]
    ctx.space = _context


def _sum_backward(ctx, g):
    if ctx.space is None:
        return _unsqueeze_rows(g, ctx.rows, slice(None))
    g = g.contiguous().clone()
    if ctx.space.group is not None:
        meshlib.all_reduce(g, ctx.space.group)
    return _unsqueeze_rows(g, ctx.rows, ctx.space.window.trim)


frame_sum.register_autograd(_sum_backward, setup_context=_sum_setup)


@torch.library.custom_op("reconfigisp::space_rows", mutates_args=())
def gather(x: torch.Tensor, reduce_grad: bool = False) -> torch.Tensor:
    """(N, rows, ...) window -> (N, frame rows, ...): the owned rows
    gathered over the space group (module docstring); a copy of x without
    a context."""
    ctx = _context
    if ctx is None:
        return x.clone()
    own = x[:, ctx.window.trim].clone(memory_format=torch.contiguous_format)
    if ctx.group is None:
        return own
    return meshlib.all_gather(own, ctx.group, dim=1)


@gather.register_fake
def _(x, reduce_grad=False):
    rows = x.shape[1] if _context is None else _context.frame
    return x.new_empty((x.shape[0], rows) + tuple(x.shape[2:]))


def _rows_setup(ctx, inputs, output):
    ctx.rows = inputs[0].shape[1]
    ctx.reduce = inputs[1]
    ctx.space = _context


def _rows_backward(ctx, g):
    space = ctx.space
    if space is None:
        return g, None
    if ctx.reduce and space.group is not None:
        g = g.contiguous().clone()
        meshlib.all_reduce(g, space.group)
    win = space.window
    out = g.new_zeros((g.shape[0], ctx.rows) + tuple(g.shape[2:]))
    out[:, win.trim] = g[:, win.own_start:win.own_stop]
    return out, None


gather.register_autograd(_rows_backward, setup_context=_rows_setup)

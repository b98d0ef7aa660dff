"""Data-parallel and space-parallel steps and applies over the mesh.

Counterpart of reconfigisp_tpu/parallel/dp.py:89-108.  JAX jits the whole
step with the batch sharded (N over data, H over space) and the state
replicated, and XLA's SPMD partitioner computes the global batch's loss and
its exact gradient.  The port computes the same thing by hand.

Over data, each rank takes its images of the global batch and its
criterion returns its additive share of the global loss (utils/losses.py,
yolo/loss.py: counts such as the local/global flags and the YOLO object
cells are reduced over the data group).

Over space, each rank runs the network on a window of its images' frames
and keeps its owned rows (parallel/space.py: windows with a halo, the
global ops reduced over the space group).  The trimmed prediction is
gathered over the space group, so the criterion sees the whole frame and
every space rank computes the same loss; the gather's backward keeps this
rank's rows of the gradient, so rank r's parameter gradient is
dL/d(its rows) d(its rows)/dtheta.

The invariant: the SUM over the whole mesh (data x space) of the ranks'
parameter gradients is the global batch's gradient, and the SUM over the
data group of the ranks' losses is the global batch's loss.  So the
gradients are SUM-reduced over the data group and then the space group
(`reduce_grads`), and the logged losses over the data group only.  DDP's
average of per-rank gradients equals the global gradient only for a plain
mean over equal shards, which the count-normalised losses are not; DDP is
not used.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from reconfigisp_tpu_torch.parallel import mesh as meshlib
from reconfigisp_tpu_torch.parallel import space as spacelib


def reduce_grads(tensors: list, *groups) -> None:
    """SUM each tensor over each of `groups` in turn (None is skipped), in
    place: one flat buffer, one all_reduce a group, written back.
    Capture-safe under NCCL (no host read)."""
    groups = [g for g in groups if g is not None]
    if not groups or not tensors:
        return
    if any(t.dtype != tensors[0].dtype for t in tensors):
        raise TypeError("reduce_grads takes tensors of one dtype")
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    for group in groups:
        meshlib.all_reduce(flat, group)
    offset = 0
    with torch.no_grad():
        for t in tensors:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def make_data_parallel_step(step: Callable, mesh: DeviceMesh) -> Callable:
    """step(variables, opt_state, batch, lr_scale) -> (variables, opt_state,
    logs) over the mesh: `step` was built with the mesh's data group and,
    on a mesh with a space axis, its space axis
    (search/darts.make_darts_step(..., group=, space=)), so it reduces its
    gradients and logs; this takes this rank's images of the global batch
    (a leading steps axis where lr_scale is a vector, as
    make_darts_multi_step takes it), whole frames, and returns the
    replicated state and the global logs.  A step without the space axis
    on such a mesh raises ValueError: it would step on half frames."""
    if mesh.size(1) > 1 and getattr(step, "space", None) is None:
        raise ValueError(
            f"a mesh with space = {mesh.size(1)} needs a step built with its "
            "space axis (make_darts_step(..., space=))")

    def dp_step(variables, opt_state, batch, lr_scale):
        stacked = torch.as_tensor(lr_scale).ndim == 1
        return step(variables, opt_state,
                    meshlib.shard_data(mesh, batch, stacked=stacked),
                    lr_scale)

    return dp_step


def make_data_parallel_apply(apply: Callable, mesh: DeviceMesh, *,
                             halo: Optional[int] = None) -> Callable:
    """apply(variables, x) -> y over the mesh, called on every rank with
    the global batch: x's images sharded over data; on a mesh with a space
    axis each rank runs `apply` on its window of the frames under the space
    context (parallel/space.py) and keeps its owned rows, and the rows are
    gathered over space; y gathered back to the global batch in rank
    order.  `halo` is the row radius of `apply`'s network
    (space.radius(net)); None makes the whole frame every rank's window,
    which is right for any network."""
    data = mesh.get_group(meshlib.DATA_AXIS)
    axis = spacelib.SpaceAxis.of(mesh, halo)

    def dp_apply(variables, x):
        x = meshlib.shard_data(mesh, x)
        if axis is None:
            y = apply(variables, x)
        else:
            with axis.frame(x.shape[1]):
                y = spacelib.gather(apply(variables, axis.take(x)))
        return meshlib.all_gather(y, data)

    return dp_apply

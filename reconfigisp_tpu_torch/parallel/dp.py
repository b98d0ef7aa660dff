"""Data-parallel steps and applies over the mesh.

Counterpart of reconfigisp_tpu/parallel/dp.py:89-108.  JAX jits the whole
step with the batch sharded and the state replicated, and XLA's SPMD
partitioner computes the global batch's loss and its exact gradient.  The
port computes the same thing by hand: each rank's criterion returns its
additive share of the global loss (utils/losses.py, yolo/loss.py: counts
such as the local/global flags and the YOLO object cells are reduced over
the data group), so the SUM of the shares' gradients, one all-reduce
(`reduce_grads`), is the global gradient.  DDP's average of per-rank
gradients equals it only for a plain mean over equal shards, which the
count-normalised losses are not; DDP is not used.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.distributed.device_mesh import DeviceMesh

from reconfigisp_tpu_torch.parallel import mesh as meshlib


def reduce_grads(tensors: list, group) -> None:
    """SUM each tensor over `group`, in place: one flat buffer, one
    all_reduce, written back.  Capture-safe under NCCL (no host read)."""
    if any(t.dtype != tensors[0].dtype for t in tensors):
        raise TypeError("reduce_grads takes tensors of one dtype")
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    meshlib.all_reduce(flat, group)
    offset = 0
    with torch.no_grad():
        for t in tensors:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def make_data_parallel_step(step: Callable, mesh: DeviceMesh) -> Callable:
    """step(variables, opt_state, batch, lr_scale) -> (variables, opt_state,
    logs) over the mesh: `step` was built with the mesh's data group
    (search/darts.make_darts_step(..., group=)), so it reduces its
    gradients and logs; this shards the global batch (a leading steps axis
    where lr_scale is a vector, as make_darts_multi_step takes it) and
    returns the replicated state and the global logs."""
    def dp_step(variables, opt_state, batch, lr_scale):
        stacked = torch.as_tensor(lr_scale).ndim == 1
        return step(variables, opt_state,
                    meshlib.shard_batch(mesh, batch, stacked=stacked),
                    lr_scale)

    return dp_step


def make_data_parallel_apply(apply: Callable, mesh: DeviceMesh) -> Callable:
    """apply(variables, x) -> y over the mesh: x sharded over data, y
    gathered back to the global batch in rank order.  A mesh with a space
    axis raises: whole-frame sharding of H waits for halo exchanges
    (ROADMAP.md, the whole-frame space axis)."""
    if mesh.size(1) > 1:
        raise NotImplementedError(
            f"space = {mesh.size(1)} on whole frames: the port has no halo "
            "exchange yet (ROADMAP.md, the item on the whole-frame space "
            "axis)")
    group = mesh.get_group(meshlib.DATA_AXIS)

    def dp_apply(variables, x):
        y = apply(variables, meshlib.shard_batch(mesh, x))
        return meshlib.all_gather(y, group)

    return dp_apply

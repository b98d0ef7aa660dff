"""Process groups, the (data, space) mesh and the sharding of a batch.

Counterpart of reconfigisp_tpu/parallel/mesh.py:20-66.  JAX runs one
controller over jax.devices(); the port runs one process per card, started
by torchrun (`python -m torch.distributed.run`) or by parallel/launch.spawn,
and a "device" of the JAX mesh is a rank of the port's mesh.  Rank r drives
cuda:(LOCAL_RANK % device_count), set before any allocation.

The backend is NCCL where every rank of a host has a card of its own, and
gloo on the CPU or where ranks share a card (NCCL puts no two ranks on one
device).  A gloo collective on CUDA tensors is staged through the CPU here,
explicitly (`collective`), so that nothing depends on what gloo does with
device memory.

The mesh is a torch.distributed DeviceMesh with dims ("data", "space") over
the first n ranks, shaped (n // space, space) as JAX shapes it.  Its device
type is "cuda" under NCCL and "cpu" under gloo, where the collectives run on
host copies.  `shard_slices` is the sharding rule of a NamedSharding as a
pure function of the rank's mesh coordinates, so it is testable without a
group; `shard_batch` applies it.  The trainers, the applies and the serving
artifact take whole frames (`shard_data`: N over data only) and split
height over space through windows with a halo (parallel/space.py).
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

DATA_AXIS = "data"
SPACE_AXIS = "space"

log = logging.getLogger(__name__)


def init_process_group(device, *, init_method: Optional[str] = None,
                       rank: Optional[int] = None,
                       world: Optional[int] = None) -> str:
    """Start the default process group -> its backend.

    From torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK,
    LOCAL_WORLD_SIZE, MASTER_ADDR/PORT), or from an explicit `init_method`
    with `rank` and `world` (one host: the local rank is the rank).  On
    CUDA the rank's card is made current before the group allocates
    anything, so "cuda" names it from then on.  The backend is "nccl" when
    the ranks of the host each drive a card of their own, else "gloo" (the
    CPU, or ranks sharing a card).  Rank 0 logs the choice."""
    if init_method is None:
        rank = int(os.environ["RANK"])
        world = int(os.environ["WORLD_SIZE"])
        local_rank = int(os.environ.get("LOCAL_RANK", "0"))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    else:
        local_rank, local_world = rank, world
    dev = torch.device(device)
    backend = "gloo"
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        dev = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(dev)
        if local_world <= cards:
            backend = "nccl"
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world)
    if rank == 0:
        log.warning("process group: %s over %d ranks, %d on this host, "
                    "rank 0 on %s", backend, world, local_world, dev)
    return backend


def world_size() -> int:
    """The default group's ranks; 1 without a group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    """Rank 0, or no group: the process that saves, logs and probes."""
    return not dist.is_initialized() or dist.get_rank() == 0


def make_mesh(n_devices: Optional[int] = None, space: int = 1) -> DeviceMesh:
    """Mesh of shape (n // space, space) over ranks 0..n-1 (every rank by
    default).  space splits image height.  Every rank of the default group
    calls it."""
    n = world_size() if n_devices is None else int(n_devices)
    if n > world_size() or n % space:
        raise ValueError(f"mesh of {n} ranks with space {space}: the group "
                         f"has {world_size()} ranks")
    backend = dist.get_backend()
    ranks = torch.arange(n).reshape(n // space, space)
    return DeviceMesh("cuda" if backend == "nccl" else "cpu", ranks,
                      mesh_dim_names=(DATA_AXIS, SPACE_AXIS))


def shard_slices(shape, data_index: int, data_size: int,
                 space_index: int, space_size: int,
                 stacked: bool = False) -> tuple:
    """The slices of an array of `shape` that the mesh coordinate (data
    index, space index) holds under JAX's shard_batch rules: 4-D arrays
    split N over data and H over space, other arrays with a batch axis split
    N over data, scalars replicate; `stacked` (a leading steps axis) shifts
    the rules right by one.  Raises ValueError on an axis the mesh does not
    divide, as a NamedSharding does."""
    ndim = len(shape)
    lead = 1 if stacked else 0
    rank_ndim = ndim - lead
    split = []
    if rank_ndim >= 1:
        split.append((lead, data_index, data_size))
    if rank_ndim == 4:
        split.append((lead + 1, space_index, space_size))
    slices = [slice(None)] * ndim
    for axis, index, size in split:
        if shape[axis] % size:
            raise ValueError(
                f"axis {axis} of an array of shape {tuple(shape)} has size "
                f"{shape[axis]}, which the mesh's {size} shards do not "
                "divide")
        part = shape[axis] // size
        slices[axis] = slice(index * part, (index + 1) * part)
    return tuple(slices)


def coordinate(mesh: DeviceMesh) -> tuple:
    """(data index, data size, space index, space size) of this rank."""
    return (mesh.get_local_rank(DATA_AXIS), mesh.size(0),
            mesh.get_local_rank(SPACE_AXIS), mesh.size(1))


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _shard(tree, coord: tuple, stacked: bool):
    def put(x):
        if not isinstance(x, (torch.Tensor, np.ndarray)):
            return x
        return x[shard_slices(x.shape, *coord, stacked=stacked)]

    return _map(put, tree)


def shard_batch(mesh: DeviceMesh, tree, *, stacked: bool = False):
    """This rank's part of a global batch (nested dicts of tensors, numpy
    arrays or numbers), by `shard_slices`; tensors and arrays come back as
    views of the same type."""
    return _shard(tree, coordinate(mesh), stacked)


def shard_data(mesh: DeviceMesh, tree, *, stacked: bool = False):
    """This rank's images of a global batch, whole frames: shard_batch's
    rule with N over data and nothing over space (the space axis takes
    windows of the frames, parallel/space.py)."""
    data_index, data_size, _, _ = coordinate(mesh)
    return _shard(tree, (data_index, data_size, 0, 1), stacked)


def collective(fn: Callable, tensor: torch.Tensor, group) -> torch.Tensor:
    """fn(t) on `tensor` in place: on a host copy under gloo when the tensor
    is on a card (written back after), on the tensor itself otherwise."""
    if tensor.is_cuda and dist.get_backend(group) == "gloo":
        host = tensor.detach().cpu()
        fn(host)
        tensor.copy_(host)
    else:
        fn(tensor)
    return tensor


def all_reduce(tensor: torch.Tensor, group) -> torch.Tensor:
    """SUM over the group, in place."""
    return collective(lambda t: dist.all_reduce(t, group=group), tensor,
                      group)


def all_gather(tensor: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors concatenated along `dim` in rank order: NCCL's
    all_gather_into_tensor, gloo's list form on host copies."""
    n = dist.get_world_size(group)
    if n == 1:
        return tensor
    moved = tensor.movedim(dim, 0).contiguous()
    if dist.get_backend(group) == "nccl":
        out = moved.new_empty((n * moved.shape[0],) + moved.shape[1:])
        dist.all_gather_into_tensor(out, moved, group=group)
    else:
        host = moved.cpu()
        parts = [torch.empty_like(host) for _ in range(n)]
        dist.all_gather(parts, host, group=group)
        out = torch.cat(parts).to(tensor.device)
    return out.movedim(0, dim)


def replicate(mesh: DeviceMesh, tree):
    """Every tensor of `tree` (nested dicts of tensors and modules) set to
    the mesh's first rank's, in place: a broadcast along space from each
    row's first rank, then along data from the first row."""
    def bcast(t):
        for axis in (SPACE_AXIS, DATA_AXIS):
            group = mesh.get_group(axis)
            if dist.get_world_size(group) > 1:
                src = dist.get_global_rank(group, 0)
                collective(lambda h: dist.broadcast(h, src, group=group),
                           t, group)
        return t

    def put(x):
        if isinstance(x, torch.nn.Module):
            with torch.no_grad():
                for t in list(x.parameters()) + list(x.buffers()):
                    bcast(t.data)
        elif isinstance(x, torch.Tensor):
            with torch.no_grad():
                bcast(x.data)
        return x

    return _map(put, tree)

"""Run a function on every rank of a process group started here.

`spawn` is the single-call counterpart of the JAX package's one controller
over jax.devices(): it starts `world` processes, each of which joins a
group through a `file://` store (no port to clash under parallel test
workers), runs fn(rank, *args) and leaves the group.  A rank that fails
fails the call, and the others are stopped.  The tests and the dry run
(parallel/dryrun.py) use it; a user's run goes through torchrun.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from reconfigisp_tpu_torch.parallel import mesh as meshlib


def _rank_main(rank: int, fn: Callable, world: int, device: str,
               init_file: str, args: tuple) -> None:
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    meshlib.init_process_group(device, init_method=f"file://{init_file}",
                               rank=rank, world=world)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, *, device, init_file: str,
          args: tuple = ()) -> None:
    """fn(rank, *args) in `world` new processes (the spawn start method),
    in one process group over `device` ("cpu" or "cuda"); init_file is a
    path that does not exist yet, the group's store.  fn must be importable
    by name (a module-level function).  Returns when every rank has
    returned; raises if one failed."""
    mp.start_processes(_rank_main,
                       args=(fn, world, str(device), init_file, args),
                       nprocs=world, join=True, start_method="spawn")

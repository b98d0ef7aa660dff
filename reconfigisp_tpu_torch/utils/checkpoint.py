"""Checkpoints: a versioned pickle of numpy trees, both ways.

Counterpart of reconfigisp_tpu/utils/checkpoint.py; pure pickle and numpy.
The format and the file names are the JAX package's ({iter}_{label}.ckpt
for a network, {iter}.state for a training state), so either package reads
what the other writes; the trees hold the JAX layout (convert.state_to_jax,
convert.adam_state_to_jax).  Unpickling runs code from the file, so load
only checkpoints this project wrote.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Optional

import numpy as np
import torch

FORMAT_VERSION = 1
_MAGIC = "__reconfigisp_ckpt__"


def to_numpy(tree):
    """Every leaf of nested dicts, lists and tuples as a numpy array
    (a tensor's detached CPU copy); None stays None, as in a JAX tree."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def _wrap(payload: Any) -> dict:
    return {_MAGIC: FORMAT_VERSION, "payload": payload}


def _unwrap(obj: Any) -> Any:
    """Accept both versioned and legacy (bare-pytree) checkpoints."""
    if isinstance(obj, dict) and _MAGIC in obj:
        ver = obj[_MAGIC]
        if ver > FORMAT_VERSION:
            raise ValueError(
                f"checkpoint format {ver} is newer than supported "
                f"({FORMAT_VERSION})")
        return obj["payload"]
    return obj


def save_network(path_dir: str, label: str, iter_label, variables) -> str:
    """-> <dir>/<iter>_<label>.ckpt (reference base_model.py:77-85)."""
    os.makedirs(path_dir, exist_ok=True)
    path = os.path.join(path_dir, f"{iter_label}_{label}.ckpt")
    with open(path, "wb") as f:
        pickle.dump(_wrap(to_numpy(variables)), f)
    return path


def load_network(path: str):
    with open(path, "rb") as f:
        return _unwrap(pickle.load(f))


def save_training_state(path_dir: str, iter_label, *, epoch: int, step: int,
                        variables, opt_state,
                        extra: Optional[dict] = None) -> str:
    """-> <dir>/<iter>.state (reference base_model.py:99-108)."""
    os.makedirs(path_dir, exist_ok=True)
    path = os.path.join(path_dir, f"{iter_label}.state")
    state = {
        "epoch": epoch,
        "step": step,
        "variables": to_numpy(variables),
        "opt_state": to_numpy(opt_state),
        "extra": to_numpy(extra) if extra is not None else None,
    }
    with open(path, "wb") as f:
        pickle.dump(_wrap(state), f)
    return path


def load_training_state(path: str) -> dict:
    """A <iter>.state file's {"epoch", "step", "variables", "opt_state",
    "extra"}."""
    return load_network(path)


def latest_state(path_dir: str) -> Optional[str]:
    """Most recent .state file by iteration number, if any."""
    if not os.path.isdir(path_dir):
        return None
    states = [f for f in os.listdir(path_dir) if f.endswith(".state")]
    if not states:
        return None
    states.sort(key=lambda f: int(f.split(".")[0]))
    return os.path.join(path_dir, states[-1])

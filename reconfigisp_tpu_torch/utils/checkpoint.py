"""Read the JAX package's checkpoints: a versioned pickle of numpy pytrees.

Counterpart of the load side of reconfigisp_tpu/utils/checkpoint.py; pure
pickle and numpy.  Unpickling runs code from the file, so load only
checkpoints this project wrote.
"""

from __future__ import annotations

import pickle
from typing import Any

FORMAT_VERSION = 1
_MAGIC = "__reconfigisp_ckpt__"


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


def load_network(path: str):
    with open(path, "rb") as f:
        return _unwrap(pickle.load(f))

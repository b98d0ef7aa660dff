"""Carry a JAX pipeline state (or a module bank) across to the port.

A JAX state is {"logits": {step_name: (P,)}, "weights": {op_name: pytree}}
given as numpy arrays (utils/checkpoint.load_network returns that form).
Weight pytrees are nested dicts and lists whose leaves are conv dicts
{"w": (kh, kw, Cin, Cout) HWIO, "b": (Cout,)}; each becomes the
`<path>.weight` (OIHW) and `<path>.bias` entries of a PyTorch state_dict,
with list positions as indices, so Path-Restore's
{"conv_first", "blocks": [{"conv1", "conv2"}] * 6, "conv_last"} maps onto
PathRestore14 in order.
"""

from __future__ import annotations

import numpy as np
import torch


def _conv_entries(tree, prefix: str, out: dict) -> dict:
    if isinstance(tree, dict) and set(tree) == {"w", "b"}:
        w = np.asarray(tree["w"], np.float32)
        out[prefix + "weight"] = torch.from_numpy(
            np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
        out[prefix + "bias"] = torch.from_numpy(
            np.asarray(tree["b"], np.float32).copy())
    elif isinstance(tree, dict):
        for key, sub in tree.items():
            _conv_entries(sub, f"{prefix}{key}.", out)
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            _conv_entries(sub, f"{prefix}{i}.", out)
    else:
        raise TypeError(f"unexpected leaf at {prefix!r}: {type(tree)}")
    return out


def weights_from_jax(tree) -> dict:
    """One op's weight pytree -> its PyTorch state_dict."""
    return _conv_entries(tree, "", {})


def state_from_jax(np_state: dict) -> dict:
    """JAX state (numpy) -> the state Pipeline.load_state takes."""
    logits = {step: torch.from_numpy(np.asarray(v, np.float32).copy())
              for step, v in np_state.get("logits", {}).items()
              if v is not None}
    weights = {op: weights_from_jax(tree)
               for op, tree in np_state.get("weights", {}).items()}
    return {"logits": logits, "weights": weights}

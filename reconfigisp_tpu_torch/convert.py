"""Carry a JAX pipeline state (or a module bank) across to the port.

A JAX state is {"logits": {step_name: (P,)}, "weights": {name: pytree}}
given as numpy arrays (utils/checkpoint.load_network returns that form).  A
weights name is an op's, or a step's (`step{i}_{op}`) for a step with
weights of its own; names pass through as they are.  Weight pytrees are nested dicts and lists whose leaves are conv dicts
{"w": (kh, kw, Cin, Cout) HWIO, "b": (Cout,)}; each becomes the
`<path>.weight` (OIHW) and `<path>.bias` entries of a PyTorch state_dict,
with list positions as indices, so Path-Restore's
{"conv_first", "blocks": [{"conv1", "conv2"}] * 6, "conv_last"} maps onto
PathRestore14 in order, and SRCNN's {"conv1", "conv2", "conv3"} onto
SRCNNRes and SRCNNDemosaic.  Logits are copied as they are: squashed ops
keep their logits, conditional ops their raw flat vector.
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


def state_from_bank(bank: dict, pipe) -> dict:
    """The weights `pipe` needs, from a module bank keyed by op name (the
    in-repo experiments/proxies/default.ckpt, read by
    utils/checkpoint.load_network): native CNN weights, the proxies where
    the pipeline runs them, and bm3d's proxy always.  Raises KeyError when
    the bank lacks one."""
    return {"weights": {name: weights_from_jax(bank[name])
                        for name in pipe.weights}}

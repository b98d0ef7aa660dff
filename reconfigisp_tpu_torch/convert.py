"""Carry a pipeline state (or a module bank) between the JAX package and the port.

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

The other way, `state_to_jax` gives a pipeline's state in that layout, and
`adam_state_to_jax` / `adam_state_from_jax` carry torch.optim.Adam's
per-parameter exp_avg, exp_avg_sq and step to and from the JAX package's
{"m", "v", "t"} trees (reconfigisp_tpu/utils/optim.py:28-31), whose m and v
have the trained part of the state's layout: {"logits"}, and {"weights"}
too where the weights are trained.
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


def _listify(node):
    """Dicts keyed "0", "1", ... (a ModuleList's positions) -> lists."""
    if not isinstance(node, dict) or set(node) == {"w", "b"}:
        return node
    node = {k: _listify(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        return [node[str(i)] for i in range(len(node))]
    return node


def weights_to_jax(entries: dict):
    """Inverse of weights_from_jax: {"<path>.weight" (OIHW), "<path>.bias"}
    -> the pytree of conv dicts {"w": HWIO, "b"} as numpy."""
    tree: dict = {}
    for key, value in entries.items():
        *path, kind = key.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        value = value.detach().cpu().numpy()
        if kind == "weight":
            node["w"] = np.ascontiguousarray(value.transpose(2, 3, 1, 0))
        else:
            node["b"] = value.copy()
    return _listify(tree)


def _jax_tree(pipe, leaf, weights: bool) -> dict:
    """{"logits": {step: leaf(p)}} and, with `weights`, {"weights": {name:
    pytree of leaf(p)}} over the pipeline's parameters p, in the JAX
    layout."""
    tree = {"logits": {step: leaf(p).detach().cpu().numpy().copy()
                       for step, p in pipe.logits.items()}}
    if weights:
        tree["weights"] = {
            name: weights_to_jax({k: leaf(p)
                                  for k, p in mod.named_parameters()})
            for name, mod in pipe.weights.items()}
    return tree


def state_to_jax(pipe) -> dict:
    """The pipeline's state as the JAX package holds it, in numpy: the
    inverse of state_from_jax."""
    return _jax_tree(pipe, lambda p: p, weights=True)


def adam_state_to_jax(optimizer: torch.optim.Adam, pipe) -> dict:
    """torch.optim.Adam's state over the pipeline's logits, and over its
    weights where the optimizer holds them -> {"m", "v", "t"}.  A parameter
    that has had no gradient yet (the median's logit never gets one) has
    m = v = 0, as in JAX, where its gradient is 0; t is the steps taken."""
    state = optimizer.state
    held = {id(p) for group in optimizer.param_groups for p in group["params"]}
    weights = any(id(p) in held for p in pipe.weights.parameters())

    def moment(key):
        return lambda p: (state[p][key] if p in state
                          else torch.zeros_like(p))

    t = max((int(st["step"]) for st in state.values()), default=0)
    return {"m": _jax_tree(pipe, moment("exp_avg"), weights),
            "v": _jax_tree(pipe, moment("exp_avg_sq"), weights),
            "t": np.asarray(t, np.int32)}


def adam_state_from_jax(opt_state: dict, pipe,
                        optimizer: torch.optim.Adam) -> None:
    """Set the Adam state of every parameter that {"m", "v", "t"} covers:
    the pipeline's logits, and its weights where the trees hold them."""
    t = torch.tensor(float(opt_state["t"]), dtype=torch.float32)
    params = dict(pipe.logits.items())
    m = {k: torch.from_numpy(np.asarray(v, np.float32).copy())
         for k, v in opt_state["m"]["logits"].items()}
    v = {k: torch.from_numpy(np.asarray(a, np.float32).copy())
         for k, a in opt_state["v"]["logits"].items()}
    for name, tree in opt_state["m"].get("weights", {}).items():
        mod = pipe.weights[name]
        for key, p in mod.named_parameters():
            params[(name, key)] = p
        m.update({(name, k): a for k, a in weights_from_jax(tree).items()})
        v.update({(name, k): a for k, a in weights_from_jax(
            opt_state["v"]["weights"][name]).items()})
    for key, p in params.items():
        optimizer.state[p] = {
            "step": t.clone(),
            "exp_avg": m[key].to(p.device).reshape(p.shape).contiguous(),
            "exp_avg_sq": v[key].to(p.device).reshape(p.shape).contiguous()}


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

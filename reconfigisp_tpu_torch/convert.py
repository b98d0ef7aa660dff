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

For the search, `supernet_variables_from_jax` / `supernet_variables_to_jax`
carry the supernet's {"alphas", "theta", "omega"} (omega's modules through
weights_from_jax / weights_to_jax), and `darts_opt_state_from_jax` /
`darts_opt_state_to_jax` the DARTS step's {"momentum", "adam_m", "adam_v",
"adam_t"} (reconfigisp_tpu/search/darts.py:63-71), which the port holds in
the same layout with tensors as leaves.
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


def _tensors(tree, device):
    """Nested dicts of numpy arrays -> the same dicts of float32 tensors."""
    if isinstance(tree, dict):
        return {k: _tensors(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree, np.float32).copy()).to(device)


def _arrays(tree):
    """Nested dicts of tensors -> the same dicts of numpy arrays."""
    if isinstance(tree, dict):
        return {k: _arrays(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy().copy()


def supernet_variables_from_jax(np_vars: dict, net) -> dict:
    """A JAX supernet's variables (numpy) -> the port's, for SuperNet `net`:
    alphas and theta as tensors on its device, omega as frozen modules of
    the kind `net` runs each op with, holding the JAX weights."""
    specs = {spec.name: spec for _, ops in net.slots for spec in ops}
    omega = {}
    for name, tree in np_vars["omega"].items():
        module = specs[name].get_init(net.use_proxies)(torch.Generator())
        module.load_state_dict(weights_from_jax(tree))
        omega[name] = module.to(net.device).requires_grad_(False)
    return {"alphas": _tensors(np_vars["alphas"], net.device),
            "theta": _tensors(np_vars["theta"], net.device),
            "omega": omega}


def supernet_variables_to_jax(variables: dict) -> dict:
    """The port's supernet variables -> the JAX layout, in numpy."""
    return {"alphas": _arrays(variables["alphas"]),
            "theta": _arrays(variables["theta"]),
            "omega": {name: weights_to_jax(dict(mod.named_parameters()))
                      for name, mod in variables["omega"].items()}}


def darts_opt_state_from_jax(np_state: dict, device) -> dict:
    """{"momentum", "adam_m", "adam_v", "adam_t"} (numpy) -> tensors on
    `device`; adam_t stays an integer count."""
    return {"momentum": _tensors(np_state["momentum"], device),
            "adam_m": _tensors(np_state["adam_m"], device),
            "adam_v": _tensors(np_state["adam_v"], device),
            "adam_t": torch.tensor(int(np_state["adam_t"]), dtype=torch.int32,
                                   device=device)}


def darts_opt_state_to_jax(state: dict) -> dict:
    """The inverse of darts_opt_state_from_jax."""
    return {"momentum": _arrays(state["momentum"]),
            "adam_m": _arrays(state["adam_m"]),
            "adam_v": _arrays(state["adam_v"]),
            "adam_t": np.asarray(int(state["adam_t"]), np.int32)}

"""YAML option files with NoneDict semantics.

Counterpart of reconfigisp_tpu/config.py (reference
codes/options/options.py:8-93), kept as its own copy: the port imports
nothing of the JAX package.  `parse` reads a configs/*.yaml file into a dict
that returns None for a missing key, derives the experiment's path tree
under a root, installs the default module bank when the file names none, and
shortens the frequencies of a run whose name holds "debug".
"""

from __future__ import annotations

import os
from typing import Any, Optional

import yaml


class NoneDict(dict):
    """dict returning None for missing keys (reference options.py:78-82)."""

    def __missing__(self, key):
        return None


def dict_to_nonedict(opt: Any) -> Any:
    if isinstance(opt, dict):
        return NoneDict({k: dict_to_nonedict(v) for k, v in opt.items()})
    if isinstance(opt, list):
        return [dict_to_nonedict(v) for v in opt]
    return opt


def parse(opt_path: str, is_train: bool = True,
          root: Optional[str] = None) -> NoneDict:
    """Load a YAML option file and derive the path tree
    (reference options.py:8-62)."""
    with open(opt_path) as f:
        opt = yaml.safe_load(f)
    return parse_dict(opt, is_train=is_train, root=root)


def parse_dict(opt: dict, is_train: bool = True,
               root: Optional[str] = None) -> NoneDict:
    opt = dict(opt)
    opt["is_train"] = is_train
    name = opt.get("name", "experiment")

    root = root or opt.get("path", {}).get("root") or os.getcwd()
    paths = dict(opt.get("path") or {})
    if is_train:
        experiments_root = os.path.join(root, "experiments", name)
        paths.update({
            "root": root,
            "experiments_root": experiments_root,
            "models": os.path.join(experiments_root, "models"),
            "training_state": os.path.join(experiments_root, "training_state"),
            "log": experiments_root,
            "val_images": os.path.join(experiments_root, "val_images"),
        })
        # the default pretrained module bank (the reference's IspUniversal
        # loads a default checkpoint for every CNN module,
        # isp_universal.py:32-51): when the file names no pretrain_proxies
        # and <root>/experiments/proxies/default.ckpt exists, install it
        if not paths.get("pretrain_proxies"):
            default_bank = os.path.join(root, "experiments", "proxies",
                                        "default.ckpt")
            if os.path.exists(default_bank):
                paths["pretrain_proxies"] = default_bank
        # debug-mode overrides (reference options.py:53-56)
        if "debug" in name:
            train = opt.setdefault("train", {})
            logger = opt.setdefault("logger", {})
            logger["print_freq"] = 2
            logger["save_checkpoint_freq"] = 8
            train.setdefault("niter", 8)
    else:
        results_root = os.path.join(root, "results", name)
        paths.update({
            "root": root,
            "results_root": results_root,
            "log": results_root,
        })
    opt["path"] = paths
    return dict_to_nonedict(opt)


def dict2str(opt: dict, indent: int = 1) -> str:
    """Pretty-printer (reference options.py:64-76)."""
    msg = ""
    for k, v in opt.items():
        if isinstance(v, dict):
            msg += " " * (indent * 2) + f"{k}:[\n"
            msg += dict2str(v, indent + 1)
            msg += " " * (indent * 2) + "]\n"
        else:
            msg += " " * (indent * 2) + f"{k}: {v}\n"
    return msg


def network_uses_proxy(net_opt: dict) -> bool:
    """Proxy or native ops for a network_G block: an explicit `use_proxy`
    key wins, even False; else the reference's spelling, which_model_G
    IspUniversal (proxies) or OriginUniversal (native ops)
    (reference codes/models/networks.py:31-45)."""
    if net_opt.get("use_proxy") is not None:
        return bool(net_opt["use_proxy"])
    return net_opt.get("which_model_G") == "IspUniversal"


def supernet_kwargs(opt: dict) -> dict:
    """SuperNet's arguments from a search option file, as the JAX package's
    run_training reads them (reconfigisp_tpu/search/trainer.py:690-709):
    n_step (3), prune_threshold (0.2), use_proxies (forced by model
    darts_ft), srgb_count or the reference's n_modules (15), remat (True)."""
    from reconfigisp_tpu_torch.registry import SUPERNET_SRGB_COUNT
    net_opt = opt["network_G"] or {}
    remat = net_opt.get("remat")
    return {"n_step": net_opt.get("n_step", 3) or 3,
            "threshold": net_opt.get("prune_threshold", 0.2) or 0.2,
            "use_proxies": (opt.get("model") == "darts_ft"
                            or bool(net_opt.get("use_proxies"))),
            "srgb_count": (net_opt.get("srgb_count")
                           or net_opt.get("n_modules")
                           or SUPERNET_SRGB_COUNT),
            "remat": True if remat is None else bool(remat)}

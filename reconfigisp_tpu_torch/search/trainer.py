"""Trainers: fixed-pipeline training, DARTS search, search with proxy tuning.

Counterpart of reconfigisp_tpu/search/trainer.py:
  IspTrainer     <- IspModel     (reference codes/models/isp_model.py:15-151)
  DartsTrainer   <- DartsModel   (darts_model.py:19-330) + train.py loop
  DartsFtTrainer <- DartsFtModel (darts_ft_model.py:20-368) + train_ft.py
IspTrainer's Pipeline module holds its state and torch.optim.Adam updates it
in place; the search trainers hold the supernet's variables and the DARTS
state as dicts that search/darts.py's step replaces each step.  Checkpoints
hold the JAX layout (convert.state_to_jax, convert.adam_state_to_jax,
convert.supernet_variables_to_jax, convert.darts_opt_state_to_jax), so the
JAX package resumes what these trainers save, and the reverse.  Not ported
yet (ROADMAP.md): data-parallel training (the JAX trainers' `mesh`) and the
search's K-step dispatch (`steps_per_dispatch`, `flush`).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from reconfigisp_tpu_torch import convert
from reconfigisp_tpu_torch.pipeline import Pipeline
from reconfigisp_tpu_torch.search.darts import (
    DartsConfig, init_darts_opt_state, make_darts_step)
from reconfigisp_tpu_torch.supernet import SuperNet
from reconfigisp_tpu_torch.utils import checkpoint, losses
from reconfigisp_tpu_torch.utils.schedule import make_schedule


def _tensor(v, device) -> torch.Tensor:
    """On `device`; floats as float32, as JAX takes them with 64-bit types
    off."""
    t = torch.as_tensor(v, device=device)
    return t.float() if t.is_floating_point() else t


class IspTrainer:
    """Adam on a fixed pipeline's logits, and on its CNN weights with
    `train_weights` (reference isp_model.py:86-90,128-143, which trains the
    logits only).

    The pipeline is trained where it lies (`Pipeline(..., device=...)`:
    cuda unless "cpu" was asked for).  Without `train_weights` its weights
    are frozen (requires_grad off), so the forward records no graph through
    the CNNs, as JAX differentiates the logits alone.  Batches are dicts of
    tensors or numpy arrays with "noisy" (N, H, W, 1) mosaics, the target
    under `target_key` and, for the local/global loss, "glb_flag"; they are
    moved to the pipeline's device."""

    def __init__(self, pipeline: Pipeline, train_opt: dict, *,
                 train_weights: bool = False,
                 criterion: Optional[Callable] = None,
                 target_key: str = "gt"):
        self.pipeline = pipeline
        self.train_weights = train_weights
        self.target_key = target_key
        self.criterion = criterion or losses.make_criterion(
            train_opt.get("pixel_criterion", "l2"), train_opt)
        self.schedule = make_schedule(train_opt)
        self.lr = train_opt.get("lr_G", 1e-3)
        self.beta1 = train_opt.get("beta1", 0.9)
        self.beta2 = train_opt.get("beta2", 0.99)
        self.step_idx = 0
        self._make_optimizer()
        self._last_logs = {"loss": float("nan")}

    def _make_optimizer(self) -> None:
        self.pipeline.weights.requires_grad_(self.train_weights)
        self._params = list(self.pipeline.logits.values())
        if self.train_weights:
            self._params += list(self.pipeline.weights.parameters())
        self.optimizer = torch.optim.Adam(
            self._params, lr=self.lr, betas=(self.beta1, self.beta2),
            eps=1e-8)

    @property
    def last_logs(self) -> dict:
        """The latest train step's metrics; restored on resume, so a run
        that resumes complete reports its checkpointed loss."""
        return dict(self._last_logs)

    def _tensor(self, v) -> torch.Tensor:
        return _tensor(v, self.pipeline.device)

    def _batch(self, batch: dict) -> dict:
        return {k: self._tensor(v) for k, v in batch.items()}

    def _loss(self, batch: dict) -> torch.Tensor:
        pred, _, latency = self.pipeline(batch["noisy"],
                                         return_intermediates=True)
        kw = {"glb_flag": batch["glb_flag"]} if "glb_flag" in batch else {}
        return self.criterion(pred, batch[self.target_key], latency=latency,
                              **kw)

    def train_step(self, batch: dict) -> dict:
        """One Adam step at lr_G times the schedule's scale of the step's
        1-based index -> {"loss": the loss before the step}."""
        self.step_idx += 1
        lr = self.lr * self.schedule(self.step_idx)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        loss = self._loss(self._batch(batch))
        grads = torch.autograd.grad(loss, self._params, allow_unused=True)
        for p, g in zip(self._params, grads):
            p.grad = g  # None where no gradient reaches p: Adam skips it
        self.optimizer.step()
        self._last_logs = {"loss": float(loss.detach())}
        return dict(self._last_logs)

    @torch.no_grad()
    def eval_loss(self, batch: dict) -> float:
        """The criterion on a batch, with no update: evaluated on the same
        samples before and after training, its fall shows learning without
        the per-batch variance of the training loss."""
        return float(self._loss(self._batch(batch)))

    @torch.no_grad()
    def test(self, noisy) -> tuple:
        """-> (output, {step_name: intermediate}) (reference
        isp_model.py:144-151)."""
        y, mids, _ = self.pipeline(self._tensor(noisy),
                                   return_intermediates=True)
        return y, mids

    def save(self, models_dir: str, state_dir: str, epoch: int):
        """<models_dir>/<step>_G.ckpt and <state_dir>/<step>.state, in the
        JAX package's layout (reference base_model.py:99-108)."""
        variables = convert.state_to_jax(self.pipeline)
        checkpoint.save_network(models_dir, "G", self.step_idx, variables)
        checkpoint.save_training_state(
            state_dir, self.step_idx, epoch=epoch, step=self.step_idx,
            variables=variables,
            opt_state=convert.adam_state_to_jax(self.optimizer,
                                                self.pipeline),
            extra={"last_logs": self._last_logs})

    def resume(self, state_path: str) -> int:
        """Load a training state (this trainer's or the JAX package's) ->
        its epoch."""
        st = checkpoint.load_training_state(state_path)
        self.pipeline.load_state(convert.state_from_jax(st["variables"]))
        self._make_optimizer()  # load_state may add step-keyed modules
        convert.adam_state_from_jax(st["opt_state"], self.pipeline,
                                    self.optimizer)
        self.step_idx = int(st["step"])
        if (st.get("extra") or {}).get("last_logs"):
            self._last_logs = {k: float(v) for k, v in
                               st["extra"]["last_logs"].items()}
        return st["epoch"]


class DartsTrainer:
    """Bilevel search (reference DartsModel + train.py loop): one DARTS step
    per search_step, of order train_opt["darts_order"] (2 by default).

    The supernet's variables start from supernet.init(generator) and live on
    its device.  Batches are dicts of tensors or numpy arrays with "noisy"
    mosaics, the target under `target_key` and optionally "glb_flag"; they
    are moved to that device."""

    def __init__(self, supernet: SuperNet, train_opt: dict, *,
                 generator: Optional[torch.Generator] = None,
                 forward: Optional[Callable] = None,
                 criterion: Optional[Callable] = None,
                 target_key: str = "gt"):
        self.net = supernet
        self.target_key = target_key
        self.variables = supernet.init(generator)
        self.opt_state = init_darts_opt_state(self.variables)
        self.criterion = criterion or losses.make_criterion(
            train_opt.get("pixel_criterion", "l2"), train_opt)
        self.schedule = make_schedule(train_opt)
        self.cfg = DartsConfig(
            lr_theta=train_opt.get("lr_G", 1e-4),
            momentum=train_opt.get("momentum_G", 0.9),
            lr_meta=train_opt.get("lr_meta", 1e-4),
            lr_alpha=train_opt.get("lr_G", 1e-4),
            beta1=train_opt.get("beta1", 0.9),
            beta2=train_opt.get("beta2", 0.99),
            order=int(train_opt.get("darts_order", 2)))
        self.step_idx = 0
        self._last_aux: dict = {}
        if forward is None:
            def forward(theta, alphas, omega, img):
                y, aux = supernet(
                    {"theta": theta, "alphas": alphas, "omega": omega},
                    img, return_aux=True)
                return y, aux["latency"]
        self._step = make_darts_step(forward, self.criterion, self.cfg)
        self._last_logs = {"loss": float("nan"), "val_loss": float("nan")}

    def _tensor(self, v) -> torch.Tensor:
        return _tensor(v, self.net.device)

    def search_step(self, train_batch: dict, val_batch: dict) -> dict:
        """One step at lr times the schedule's scale of its 1-based index ->
        {"loss", "val_loss", "eps", "dtheta_norm"} as floats."""
        self.step_idx += 1
        lr_scale = self.schedule(self.step_idx)
        tk = self.target_key
        batch = {"img": train_batch["noisy"], "gt": train_batch[tk],
                 "val_img": val_batch["noisy"], "val_gt": val_batch[tk]}
        if "glb_flag" in train_batch:
            batch["glb_flag"] = train_batch["glb_flag"]
            batch["val_glb_flag"] = val_batch["glb_flag"]
        batch = {k: self._tensor(v) for k, v in batch.items()}
        self.variables, self.opt_state, logs = self._step(
            self.variables, self.opt_state, batch, lr_scale)
        # tensors beside the scalars (the ft trainer's intermediates) ride in
        # underscore-keyed entries
        self._last_aux = {k: logs.pop(k) for k in list(logs)
                          if k.startswith("_")}
        self._last_logs = {k: float(v) for k, v in logs.items()}
        return dict(self._last_logs)

    @torch.no_grad()
    def pruned_paths(self, img) -> np.ndarray:
        """Pruned paths per slot at the current alphas."""
        _, aux = self.net(self.variables, self._tensor(img), return_aux=True)
        return aux["pruned"].cpu().numpy()

    def architecture(self) -> str:
        return self.net.argmax_architecture(self.variables)

    @property
    def last_logs(self) -> dict:
        """The latest step's metrics; restored on resume, so a run that
        resumes complete reports its checkpointed loss."""
        return dict(self._last_logs)

    def save(self, models_dir: str, state_dir: str, epoch: int):
        """<models_dir>/<step>_G.ckpt and <state_dir>/<step>.state in the
        JAX package's layout."""
        variables = convert.supernet_variables_to_jax(self.variables)
        checkpoint.save_network(models_dir, "G", self.step_idx, variables)
        checkpoint.save_training_state(
            state_dir, self.step_idx, epoch=epoch, step=self.step_idx,
            variables=variables,
            opt_state=convert.darts_opt_state_to_jax(self.opt_state),
            extra={"last_logs": self._last_logs})

    def resume(self, state_path: str) -> int:
        """Load a training state (this trainer's or the JAX package's) ->
        its epoch."""
        st = checkpoint.load_training_state(state_path)
        self.variables = convert.supernet_variables_from_jax(
            st["variables"], self.net)
        self.opt_state = convert.darts_opt_state_from_jax(
            st["opt_state"], self.net.device)
        self.step_idx = int(st["step"])
        if (st.get("extra") or {}).get("last_logs"):
            self._last_logs = {k: float(v) for k, v in
                               st["extra"]["last_logs"].items()}
        return st["epoch"]

    def load_pretrained(self, weights_by_name: dict) -> list:
        """Install pretrained weights (JAX pytrees by op name, as
        utils/checkpoint.load_network reads the module bank) into omega ->
        the installed op names."""
        installed = []
        for name, tree in weights_by_name.items():
            if name in self.variables["omega"]:
                self.variables["omega"][name].load_state_dict(
                    convert.weights_from_jax(tree))
                installed.append(name)
        return installed


class DartsFtTrainer(DartsTrainer):
    """Search with online proxy tuning (reference DartsFtModel/train_ft.py).

    Keeps a FIFO memory of the sRGB intermediates of the search's training
    passes (darts_ft_model.py:194-201); finetune_proxies() fits each
    ft_target proxy to its target (the native op, or dct_denoise for bm3d)
    on those, at params drawn ~ U[0, 1), with one Adam per proxy.  omega is
    shared by the slots, so one update reaches every slot."""

    def __init__(self, supernet: SuperNet, train_opt: dict,
                 proxy_ft_params: dict, **kw):
        if not supernet.use_proxies:
            raise ValueError("DartsFtTrainer requires use_proxies=True")
        if "forward" not in kw:
            # the training pass's 3-channel intermediates come back with the
            # step, so record_intermediates runs no forward of its own
            def forward(theta, alphas, omega, img):
                y, aux = supernet(
                    {"theta": theta, "alphas": alphas, "omega": omega},
                    img, return_aux=True)
                mids3 = torch.stack([m for m in aux["intermediates"]
                                     if m.shape[-1] == 3])
                return y, aux["latency"], mids3
            kw["forward"] = forward
        super().__init__(supernet, train_opt, **kw)
        self.memory_size = proxy_ft_params.get("memory_size", 1000)
        self.ft_steps = proxy_ft_params.get("ft_steps", 5)
        self.ft_interval = proxy_ft_params.get("ft_interval", 100)
        self.ft_data: list = []
        self._ft_rng = np.random.default_rng(
            train_opt.get("manual_seed", 0) or 0)
        self.ft_ops = [s for s in
                       {spec.name: spec for _, ops in supernet.slots
                        for spec in ops}.values() if s.ft_target]
        self._make_ft_optimizers()

    def _make_ft_optimizers(self) -> None:
        self.ft_opt = {s.name: torch.optim.Adam(
            self.variables["omega"][s.name].parameters(),
            lr=self.cfg.lr_alpha, betas=(self.cfg.beta1, self.cfg.beta2),
            eps=1e-8) for s in self.ft_ops}

    def resume(self, state_path: str) -> int:
        epoch = super().resume(state_path)
        self._make_ft_optimizers()  # omega's modules are new
        return epoch

    def record_intermediates(self, train_batch: Optional[dict] = None):
        """Push the sRGB intermediates of the last search_step into the FIFO
        memory, consuming them; before any step, those of a forward on
        `train_batch`."""
        mids = self._last_aux.pop("_mids", None)
        if mids is not None:
            self.ft_data.extend(mids.unbind(0))
        elif train_batch is not None and self.step_idx == 0:
            with torch.no_grad():
                _, aux = self.net(self.variables,
                                  self._tensor(train_batch["noisy"]),
                                  return_aux=True)
            self.ft_data.extend(t for t in aux["intermediates"]
                                if t.shape[-1] == 3)
        if len(self.ft_data) > self.memory_size:
            self.ft_data = self.ft_data[-self.memory_size:]

    def save(self, models_dir: str, state_dir: str, epoch: int):
        """As DartsTrainer's, and each tuned proxy as proxy_<name>
        (reference darts_ft_model.py:165-169), which a fixed pipeline's
        `module_weight_paths` can take."""
        super().save(models_dir, state_dir, epoch)
        for spec in self.ft_ops:
            module = self.variables["omega"][spec.name]
            checkpoint.save_network(
                models_dir, f"proxy_{spec.name}", self.step_idx,
                convert.weights_to_jax(dict(module.named_parameters())))

    def finetune_proxies(self) -> dict:
        """ft_steps Adam steps per ft op, each on a memory entry and params
        drawn from the trainer's numpy generator in the JAX package's order
        (integers(len), then random((1, P)), per step, per op) ->
        {"ft_<name>": the last step's loss}."""
        self.record_intermediates()
        if not self.ft_data or self.ft_steps < 1:
            return {}
        logs = {}
        for spec in self.ft_ops:
            module = self.variables["omega"][spec.name]
            optimizer = self.ft_opt[spec.name]
            params = list(module.parameters())
            target_fn = spec.ft_target_fn()
            for _ in range(self.ft_steps):
                data = self.ft_data[int(self._ft_rng.integers(
                    len(self.ft_data)))]
                p = self._ft_rng.random((1, spec.n_params)).astype(np.float32)
                p = self._tensor(p).expand(data.shape[0], spec.n_params)
                with torch.no_grad():
                    target = target_fn(data, p, None)
                module.requires_grad_(True)
                try:
                    loss = losses.l2(spec.proxy_apply(data, p, module), target)
                    grads = torch.autograd.grad(loss, params)
                finally:
                    module.requires_grad_(False)
                for param, g in zip(params, grads):
                    param.grad = g
                optimizer.step()
                optimizer.zero_grad(set_to_none=True)
            logs[f"ft_{spec.name}"] = float(loss.detach())
        return logs

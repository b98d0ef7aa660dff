"""Step-2 training: Adam on a fixed pipeline's parameters.

Counterpart of reconfigisp_tpu/search/trainer.py:IspTrainer (reference
codes/models/isp_model.py:15-151).  The JAX trainer jits a pure step over a
state pytree; here the Pipeline module holds the state and torch.optim.Adam
updates it in place.  Checkpoints hold the JAX layout (convert.state_to_jax,
convert.adam_state_to_jax), so the JAX package resumes what this trainer
saves, and the reverse.  Data-parallel training (the JAX trainer's `mesh`)
is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from reconfigisp_tpu_torch import convert
from reconfigisp_tpu_torch.pipeline import Pipeline
from reconfigisp_tpu_torch.utils import checkpoint, losses
from reconfigisp_tpu_torch.utils.schedule import make_schedule


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
        """On the pipeline's device; floats as float32, as JAX takes them
        with 64-bit types off."""
        t = torch.as_tensor(v, device=self.pipeline.device)
        return t.float() if t.is_floating_point() else t

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

"""Trainers: fixed-pipeline training, DARTS search, search with proxy tuning.

Counterpart of reconfigisp_tpu/search/trainer.py:
  IspTrainer     <- IspModel     (reference codes/models/isp_model.py:15-151)
  DartsTrainer   <- DartsModel   (darts_model.py:19-330) + train.py loop
  DartsFtTrainer <- DartsFtModel (darts_ft_model.py:20-368) + train_ft.py
  run_training   <- run_training (reference codes/train.py:58-301, train_ft.py)
  make_yolo_criterion, build_yolo_evaluator <- the same (reference
                 darts_yolo_model.py:37-40,130-137): models darts_yolo and
                 isp_yolo train under a frozen YOLOv3's detection loss
IspTrainer's Pipeline module holds its state and torch.optim.Adam updates it
in place; the search trainers hold the supernet's variables and the DARTS
state as dicts, which search/darts.py's step replaces each step on the CPU
and its CUDA graph updates in place on the card.  Checkpoints
hold the JAX layout (convert.state_to_jax, convert.adam_state_to_jax,
convert.supernet_variables_to_jax, convert.darts_opt_state_to_jax), so the
JAX package resumes what these trainers save, and the reverse.  The search
trainers dispatch `steps_per_dispatch` steps at a time, as the JAX package's
do (search/darts.make_darts_multi_step: on CUDA each step a replay of one
captured CUDA graph).

Data parallelism (the JAX trainers' `mesh`): each trainer takes a mesh
(parallel/mesh.make_mesh) whose ranks share the global batch.  Every rank
is given the whole batch, takes its images (parallel/mesh.shard_data),
computes its share of the global loss (the criterion called with the data
group) and SUM-reduces the gradients of the shares (parallel/dp), so every
rank applies the global batch's gradient, as the JAX package's sharded jit
does.  On a mesh with a space axis each rank runs the network on its
window of the frames and the criterion sees the whole frame, gathered over
the space group; the gradients are summed over the data and the space
group, the logged losses over the data group (parallel/dp.py).  DDP is not
used: it averages per-rank gradients, which equals the global gradient
only for a plain mean over equal shards, and the local/global and YOLO
losses normalise by counts over the whole batch.  A
criterion passed to a trainer with a mesh must take `group=` and return
its share (utils/losses.make_criterion, make_yolo_criterion do).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from reconfigisp_tpu_torch import convert
from reconfigisp_tpu_torch.parallel import mesh as meshlib
from reconfigisp_tpu_torch.parallel import space as spacelib
from reconfigisp_tpu_torch.parallel.dp import reduce_grads
from reconfigisp_tpu_torch.pipeline import Pipeline, resolve_device
from reconfigisp_tpu_torch.search.darts import (
    DartsConfig, _map, init_darts_opt_state, make_darts_multi_step,
    make_darts_step)
from reconfigisp_tpu_torch.supernet import SuperNet
from reconfigisp_tpu_torch.utils import checkpoint, losses, tracing
from reconfigisp_tpu_torch.utils.logging_utils import (
    MetricsLogger, setup_logger)
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
    moved to the pipeline's device.

    With a `mesh`, each rank takes its images of the global batch (on a
    space axis, its windows of their frames), backward runs on its share of
    the loss, the gradients are SUM-reduced over the mesh and Adam steps on
    the global gradient; the logged loss is the global batch's (module
    docstring).  The pipeline's state is broadcast from the mesh's first
    rank at construction.  eval_loss and test run on this rank alone, on
    the batch they are given."""

    def __init__(self, pipeline: Pipeline, train_opt: dict, *,
                 train_weights: bool = False,
                 criterion: Optional[Callable] = None,
                 target_key: str = "gt", mesh=None):
        self.pipeline = pipeline
        self.mesh = mesh
        self.group = (None if mesh is None
                      else mesh.get_group(meshlib.DATA_AXIS))
        self.space = spacelib.SpaceAxis.of(mesh, spacelib.radius(pipeline))
        if mesh is not None:
            meshlib.replicate(mesh, {"logits": pipeline.logits,
                                     "weights": pipeline.weights})
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

    def _loss(self, batch: dict, group=None) -> torch.Tensor:
        """The criterion on the pipeline's output; under the space context
        the pipeline runs on the window and the criterion sees the whole
        frame (train_step)."""
        noisy = batch["noisy"]
        if spacelib.active():
            noisy = self.space.take(noisy)
        pred, _, latency = self.pipeline(noisy, return_intermediates=True)
        if spacelib.active():
            pred = spacelib.gather(pred)
        kw = {"glb_flag": batch["glb_flag"]} if "glb_flag" in batch else {}
        if group is not None:
            kw["group"] = group
        return self.criterion(pred, batch[self.target_key], latency=latency,
                              **kw)

    def train_step(self, batch: dict) -> dict:
        """One Adam step at lr_G times the schedule's scale of the step's
        1-based index -> {"loss": the loss before the step}."""
        self.step_idx += 1
        lr = self.lr * self.schedule(self.step_idx)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        if self.mesh is not None:
            batch = meshlib.shard_data(self.mesh, batch)
        batch = self._batch(batch)
        with (self.space.frame(batch["noisy"].shape[1]) if self.space
              else contextlib.nullcontext()):
            loss = self._loss(batch, self.group)
            grads = torch.autograd.grad(loss, self._params, allow_unused=True)
        if self.group is not None:
            # the same parameters get a gradient on every rank
            reduce_grads([g for g in grads if g is not None], self.group,
                         None if self.space is None else self.space.group)
            loss = loss.detach().clone()
            reduce_grads([loss], self.group)
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

    def load_weights(self, weights_by_name: dict) -> None:
        """Install weights (JAX pytrees, as utils/checkpoint.load_network
        reads them) by op name, or by step name for a step that takes
        weights of its own; then a fresh optimizer over the parameters."""
        self.pipeline.load_state({"weights": {
            name: convert.weights_from_jax(tree)
            for name, tree in weights_by_name.items()}})
        self._make_optimizer()

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
    """Bilevel search (reference DartsModel + train.py loop): DARTS steps of
    order train_opt["darts_order"] (2 by default), `steps_per_dispatch` (K,
    1 by default) at a time.

    search_step buffers its batch and lr scale, and at every K-th call
    dispatches the K buffered steps (search/darts.make_darts_multi_step:
    on the CPU K eager steps, on CUDA K replays of the step's CUDA graph,
    K = 1 included); until then it returns the last dispatched logs, as the
    JAX trainer does.  flush() runs what is buffered; architecture(),
    save(), load_pretrained() and DartsFtTrainer.finetune_proxies() flush
    first.  The supernet's variables start from supernet.init(generator)
    and live on its device; on CUDA they are the graph's static tensors,
    which a dispatch updates in place, and resume and load_pretrained write
    into them.  Batches are dicts of tensors or numpy arrays with "noisy"
    mosaics, the target under `target_key` and optionally "glb_flag"; they
    are moved to that device, K at a time.

    With a `mesh`, each dispatch takes this rank's images of the K global
    batches (on a space axis, the step runs on its windows of the frames)
    and the step reduces over the mesh (search/darts.make_darts_step's
    `group` and `space`), so every rank holds the serial trainer's
    variables; the variables are broadcast from the
    mesh's first rank at construction.  Under a gloo group on CUDA the
    steps run eagerly (make_darts_multi_step) and `graph` is None."""

    def __init__(self, supernet: SuperNet, train_opt: dict, *,
                 generator: Optional[torch.Generator] = None,
                 forward: Optional[Callable] = None,
                 criterion: Optional[Callable] = None,
                 target_key: str = "gt", mesh=None):
        self.net = supernet
        self.target_key = target_key
        self.mesh = mesh
        self.group = (None if mesh is None
                      else mesh.get_group(meshlib.DATA_AXIS))
        self.space = spacelib.SpaceAxis.of(mesh, spacelib.radius(supernet))
        self.variables = supernet.init(generator)
        if mesh is not None:
            meshlib.replicate(mesh, self.variables)
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
        self._step = make_darts_step(forward, self.criterion, self.cfg,
                                     group=self.group, space=self.space)
        self.k = max(1, int(train_opt.get("steps_per_dispatch", 1)))
        self._multi = make_darts_multi_step(self._step, group=self.group)
        self._buf: list = []
        self._last_logs = {"loss": float("nan"), "val_loss": float("nan")}

    def _tensor(self, v) -> torch.Tensor:
        return _tensor(v, self.net.device)

    @property
    def graph(self):
        """The runner of the step's CUDA graph (search/darts._StepGraph),
        None on the CPU and before the first dispatch."""
        return self._multi.graph

    def search_step(self, train_batch: dict, val_batch: dict) -> dict:
        """One step at lr times the schedule's scale of its 1-based index,
        buffered until K are -> {"loss", "val_loss", "eps", "dtheta_norm"}
        of the last dispatched step, as floats."""
        self.step_idx += 1
        lr_scale = self.schedule(self.step_idx)
        self._buf.append((self.step_batch(train_batch, val_batch),
                          float(lr_scale)))
        if len(self._buf) < self.k:
            # buffered: the logs and variables move at the next dispatch
            return dict(self._last_logs)
        return self._dispatch()

    def step_batch(self, train_batch: dict, val_batch: dict) -> dict:
        """The step's batch (search/darts.make_darts_step) of a training
        and a validation batch, as they were given."""
        tk = self.target_key
        batch = {"img": train_batch["noisy"], "gt": train_batch[tk],
                 "val_img": val_batch["noisy"], "val_gt": val_batch[tk]}
        if "glb_flag" in train_batch:
            batch["glb_flag"] = train_batch["glb_flag"]
            batch["val_glb_flag"] = val_batch["glb_flag"]
        return batch

    def _dispatch(self) -> dict:
        """Run the buffered steps in one dispatch."""
        buf, self._buf = self._buf, []
        stacked = {}
        for key in buf[0][0]:
            values = [b[key] for b, _ in buf]
            stacked[key] = (torch.stack(values)
                            if all(isinstance(v, torch.Tensor)
                                   for v in values)
                            else np.stack([np.asarray(v) for v in values]))
        if self.mesh is not None:
            stacked = meshlib.shard_data(self.mesh, stacked, stacked=True)
        stacked = {k: self._tensor(v) for k, v in stacked.items()}
        self.variables, self.opt_state, logs = self._multi(
            self.variables, self.opt_state, stacked, [lr for _, lr in buf])
        # tensors beside the scalars (the ft trainer's intermediates, of
        # every step of the dispatch) ride in underscore-keyed entries
        self._last_aux = {k: logs.pop(k) for k in list(logs)
                          if k.startswith("_")}
        self._last_logs = {k: float(v) for k, v in logs.items()}
        return dict(self._last_logs)

    def flush(self) -> None:
        """Run the buffered steps, one replay each on CUDA, so that the
        variables hold every search_step so far."""
        if self._buf:
            self._dispatch()

    @torch.no_grad()
    def pruned_paths(self, img) -> np.ndarray:
        """Pruned paths per slot at the current (dispatched) alphas."""
        _, aux = self.net(self.variables, self._tensor(img), return_aux=True)
        return aux["pruned"].cpu().numpy()

    def architecture(self) -> str:
        self.flush()
        return self.net.argmax_architecture(self.variables)

    @property
    def last_logs(self) -> dict:
        """The latest dispatched step's metrics; restored on resume, so a
        run that resumes complete reports its checkpointed loss."""
        return dict(self._last_logs)

    def save(self, models_dir: str, state_dir: str, epoch: int):
        """<models_dir>/<step>_G.ckpt and <state_dir>/<step>.state in the
        JAX package's layout, after a flush."""
        self.flush()
        variables = convert.supernet_variables_to_jax(self.variables)
        checkpoint.save_network(models_dir, "G", self.step_idx, variables)
        checkpoint.save_training_state(
            state_dir, self.step_idx, epoch=epoch, step=self.step_idx,
            variables=variables,
            opt_state=convert.darts_opt_state_to_jax(self.opt_state),
            extra={"last_logs": self._last_logs})

    @torch.no_grad()
    def _assign(self, variables: dict, opt_state: dict) -> None:
        """Write variables and optimiser state into the trainer's own
        tensors and modules (on CUDA the step graph's inputs)."""
        for key in ("theta", "alphas"):
            _map(lambda t, v: t.copy_(v), self.variables[key],
                 variables[key])
        _map(lambda t, v: t.copy_(v), self.opt_state, opt_state)
        for name, module in self.variables["omega"].items():
            module.load_state_dict(variables["omega"][name].state_dict())

    def resume(self, state_path: str) -> int:
        """Load a training state (this trainer's or the JAX package's) into
        the trainer's tensors -> its epoch.  Steps still buffered are
        dropped: the state replaces the run they belong to."""
        st = checkpoint.load_training_state(state_path)
        self._buf = []
        self._assign(
            convert.supernet_variables_from_jax(st["variables"], self.net),
            convert.darts_opt_state_from_jax(st["opt_state"],
                                             self.net.device))
        self.step_idx = int(st["step"])
        if (st.get("extra") or {}).get("last_logs"):
            self._last_logs = {k: float(v) for k, v in
                               st["extra"]["last_logs"].items()}
        return st["epoch"]

    def load_pretrained(self, weights_by_name: dict) -> list:
        """Install pretrained weights (JAX pytrees by op name, as
        utils/checkpoint.load_network reads the module bank) into omega's
        modules, after a flush -> the installed op names."""
        self.flush()
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
    shared by the slots, so one update reaches every slot.  With a mesh the
    memory holds the global batch's intermediates (their owned rows
    gathered over the space group, then the images over the data group),
    so every rank tunes the same proxies from the same draws; the
    tuned proxies are then broadcast from the mesh's first rank, so that
    the cards' rounding cannot set the ranks' omega apart."""

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
        self._make_ft_optimizers()  # Adam starts anew on the loaded omega
        return epoch

    def record_intermediates(self, train_batch: Optional[dict] = None):
        """Push the sRGB intermediates of the last dispatch's steps into the
        FIFO memory, in step order, consuming them (a buffered step has
        none yet); before any step, those of a forward on `train_batch`."""
        mids = self._last_aux.pop("_mids", None)
        if mids is not None:
            if self.space is not None:
                # (K n_mids, images, owned rows, W, 3): the whole frames
                mids = meshlib.all_gather(mids, self.space.group, dim=2)
            if self.group is not None:
                # (K n_mids, images of this rank, H, W, 3): the global batch
                # in rank order, as the serial trainer records it
                mids = meshlib.all_gather(mids, self.group, dim=1)
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
        {"ft_<name>": the last step's loss}.  Buffered search steps run
        first, so that tuning comes at the step the cadence names and every
        step before it searched with the untuned omega, as in the JAX
        package; the modules are tuned in place, so the next replay of the
        step's graph reads the tuned weights."""
        self.flush()
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
        if self.mesh is not None:
            meshlib.replicate(self.mesh, {s.name: self.variables["omega"][
                s.name] for s in self.ft_ops})
        return logs


# ------------------------------------------------------------ run_training

def dist_mesh(batch_size: int):
    """`dist: true`: the mesh a data-parallel run splits the global batch
    over (the JAX package's dist_mesh, search/trainer.py:439-457).  None
    (serial) without a process group of more than one rank, as JAX runs
    serially on one device; else a (world, 1) mesh of every rank.  A batch
    that the ranks do not divide raises ValueError naming the largest
    divisor to launch with: JAX would take that many of its devices and
    leave the others idle, and the port launches no rank it cannot use."""
    world = meshlib.world_size()
    if world == 1:
        return None
    if batch_size % world:
        fit = max(k for k in range(1, world + 1) if batch_size % k == 0)
        raise ValueError(
            f"dist: true: a batch of {batch_size} does not split over "
            f"{world} ranks; launch {fit} ranks (--nproc-per-node {fit})")
    return meshlib.make_mesh(world)


def make_yolo_criterion(net, img_size: int, **loss_kw) -> Callable:
    """Frozen-YOLOv3 detection objective (reference
    darts_yolo_model.py:130-137): BGR -> RGB before the detector, whose
    weights take no gradient (yolo/net.frozen), so the loss differentiates
    the ISP output alone.  `latency` is ignored, as the JAX package ignores
    it: darts_yolo has no latency term.  `group` (a data group) makes the
    loss this rank's share of the global batch's (yolo/loss.py).  loss_kw
    forwards obj_scale / noobj_scale: match the balance the evaluator was
    trained with (yolo/train.py)."""
    from reconfigisp_tpu_torch.yolo.loss import yolo_loss
    from reconfigisp_tpu_torch.yolo.net import frozen

    frozen(net)

    def criterion(pred_bgr, labels, latency=None, group=None, **kw):
        return yolo_loss(net(pred_bgr.flip(-1)), labels, img_size,
                         group=group, **loss_kw)

    return criterion


def build_yolo_evaluator(yolo_opt: Optional[dict], device=None):
    """The frozen YoloNet the options describe, on `device` (cuda unless
    "cpu" is named): cfg "yolov3" (the full graph), "tiny_test" (the
    miniature test graph, the default) or a darknet .cfg path, `classes`
    (1 by default), and optional darknet `weights`.  Without weights it is
    the port's own seeded init, init_yolo with a torch.Generator of seed 7;
    that is not the JAX package's PRNGKey(7) init, so runs that must agree
    with JAX share one darknet file."""
    from reconfigisp_tpu_torch.yolo import cfg as ycfg
    from reconfigisp_tpu_torch.yolo.net import (
        frozen, init_yolo, load_darknet_weights)

    yolo_opt = yolo_opt or {}
    kind = yolo_opt.get("cfg", "tiny_test")
    n_cls = yolo_opt.get("classes", 1) or 1
    if kind == "yolov3":
        blocks = ycfg.yolov3_blocks(num_classes=n_cls)
    elif kind == "tiny_test":
        blocks = ycfg.yolov3_tiny_test_blocks(num_classes=n_cls)
    else:
        blocks = ycfg.parse_cfg(kind)
    dev = resolve_device(device)
    if yolo_opt.get("weights"):
        net = load_darknet_weights(blocks, yolo_opt["weights"], device=dev)
    else:
        net = init_yolo(blocks, torch.Generator().manual_seed(7), device=dev)
    return frozen(net)


def _make_val_probe(opt, dataset, trainer, is_yolo: bool,
                    n_samples: int = 2):
    """Periodic validation probe: writes in|out|gt image strips under
    path.val_images and returns the val PSNR (reference train.py:218-297),
    none for a detection run, whose samples' `gt` is the scene, not its
    target; and the criterion on the probe samples where the trainer has a
    loss-only eval.  The samples are drawn once, here (see
    _probe_access_slack)."""
    from reconfigisp_tpu_torch.utils import png
    from reconfigisp_tpu_torch.utils.imaging import tensor2bgr
    from reconfigisp_tpu_torch.utils.metrics import psnr as psnr_fn

    paths = opt.get("path") or {}
    val_dir = paths.get("val_images")
    samples = [dataset[i] for i in range(min(n_samples, len(dataset)))]

    if hasattr(trainer, "net"):
        def fwd(x):
            return trainer.net(trainer.variables, x)
    else:
        def fwd(x):
            return trainer.pipeline(x)

    # a fixed batch over the keys every sample carries, so the criterion is
    # taken on identical data at each call
    probe_batch = None
    target_key = getattr(trainer, "target_key", "gt")
    if hasattr(trainer, "eval_loss") and samples:
        keys = set(samples[0].keys())
        for s in samples[1:]:
            keys &= set(s.keys())
        keys &= {"noisy", target_key, "glb_flag"}
        if "noisy" in keys and target_key in keys:
            probe_batch = {k: np.stack([np.asarray(s[k]) for s in samples])
                           for k in keys}

    @torch.no_grad()
    def probe(step_idx: int) -> dict:
        logs = {}
        if probe_batch is not None:
            logs["probe_loss"] = trainer.eval_loss(probe_batch)
        psnrs = []
        for si, s in enumerate(samples):
            x = trainer._tensor(s["noisy"])[None]
            y = torch.clamp(fwd(x)[0], 0.0, 1.0).cpu().numpy()
            gt = s.get("gt")
            if gt is not None and not is_yolo:
                psnrs.append(float(psnr_fn(torch.from_numpy(y),
                                           torch.from_numpy(gt))))
            if val_dir:
                os.makedirs(val_dir, exist_ok=True)
                noisy = s["noisy"]
                inp = (np.repeat(noisy, 3, axis=-1)
                       if noisy.shape[-1] == 1 else noisy)
                panels = [inp, y] + ([gt] if gt is not None else [])
                strip = np.concatenate([tensor2bgr(p) for p in panels],
                                       axis=1)
                png.write(os.path.join(
                    val_dir, f"{step_idx:08d}_{si}.png"), strip)
        if psnrs:
            logs["val_psnr"] = float(np.mean(psnrs))
        return logs

    return probe


def _timing_summary(iter_times: list) -> dict:
    """compile_s: the first loop body's wall time (the kernels' build and
    the first step); steady_s_per_iter: the mean over the last half of the
    iterations."""
    if not iter_times:
        return {}
    n = len(iter_times)
    tail = iter_times[max(1, n // 2):] or iter_times[-1:]
    return {"compile_s": round(float(iter_times[0]), 3),
            "steady_s_per_iter": round(float(np.mean(tail)), 4)}


def _loss_window_summary(loss_hist: list) -> dict:
    """Means of the first and last ~10% of the finite per-iter losses,
    which vary with the crop draw."""
    if len(loss_hist) < 4:
        return {}
    w = max(2, len(loss_hist) // 10)
    return {"loss_head_mean": round(float(np.mean(loss_hist[:w])), 6),
            "loss_tail_mean": round(float(np.mean(loss_hist[-w:])), 6)}


def _val_window_summary(val_hist: list) -> dict:
    """The same windows over the bilevel val loss, which the alpha update
    optimises."""
    if len(val_hist) < 4:
        return {}
    w = max(2, len(val_hist) // 10)
    return {"val_loss_head_mean": round(float(np.mean(val_hist[:w])), 6),
            "val_loss_tail_mean": round(float(np.mean(val_hist[-w:])), 6)}


def _alpha_gap_summary(alphas: dict) -> dict:
    """Per slot, softmax(alphas): top probability minus the median one (0
    at uniform alphas), rounded to 4 decimals, and the largest gap."""
    gaps = {}
    for slot, arr in alphas.items():
        a = torch.as_tensor(arr, dtype=torch.float32).detach().cpu()
        p = torch.softmax(a, dim=0).numpy()
        gaps[slot] = round(float(np.max(p) - np.median(p)), 4)
    return {"alpha_top_minus_median": gaps,
            "alpha_gap_max": max(gaps.values()) if gaps else 0.0}


def _probe_access_slack(opt: dict, step_idx: int, n_probe: int = 2) -> int:
    """Crop-counter slack for resume: the val probe draws dataset[0..n-1]
    once at construction and once per val_freq firing, on top of the
    step x batch training draws."""
    vf = int((opt.get("logger") or {}).get("val_freq") or 0)
    return n_probe * (1 + (step_idx // vf if vf else 0))


class _Trace:
    """train.trace_steps [a, b]: a torch.profiler trace from before step
    a + 1 to after step b, written as a Chrome trace under `trace_dir` (the
    JAX package's jax.profiler trace), and beside it spans.json: the spans
    the traced steps recorded (utils/tracing.py) and, for a step captured
    as a CUDA graph, the graph's device spans in its last replay and its
    counters."""

    def __init__(self, steps, trace_dir: str, device: torch.device, logger):
        self.steps = [int(s) for s in steps] if steps else None
        self.dir = trace_dir
        self.logger = logger
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.activities = acts
        self.prof = None

    def before(self, step_idx: int) -> None:
        if self.steps and step_idx == self.steps[0]:
            tracing.reset()
            self.prof = torch.profiler.profile(activities=self.activities)
            self.prof.__enter__()

    def after(self, step_idx: int, graph=None) -> None:
        """`graph`: the step's CUDA graph runner (DartsTrainer.graph)."""
        if self.prof is not None and step_idx == self.steps[1]:
            self.prof.__exit__(None, None, None)
            os.makedirs(self.dir, exist_ok=True)
            path = os.path.join(self.dir, "trace.json")
            self.prof.export_chrome_trace(path)
            self.prof = None
            with open(os.path.join(self.dir, "spans.json"), "w") as f:
                json.dump({"spans": [s._asdict() for s in tracing.spans()],
                           "graph": _graph_record(graph)}, f, indent=1)
            self.logger.info(f"profile trace and spans written to "
                             f"{self.dir}")


def _graph_record(graph) -> Optional[dict]:
    """The graph runner's device spans in its last replay and its
    counters, None without a graph."""
    if graph is None:
        return None
    return {"device_spans": [{"name": n, "parent": p, "ms": ms}
                             for n, p, ms in graph.device_spans()],
            **{k: getattr(graph, k) for k in (
                "warmup_s", "capture_s", "record_s", "pool_bytes",
                "first_replay_s", "replays", "replay_host_s")}}


def run_training(opt: dict, *, max_iters: Optional[int] = None,
                 device=None) -> dict:
    """End-to-end training loop (reference codes/train.py:58-301 and
    train_ft.py; the JAX package's run_training) for models isp, darts,
    darts_ft and the detection-driven darts_yolo and isp_yolo -> a summary
    dict with the JAX package's keys.  Runs on `device`, else the options'
    `device`, else cuda; raises without CUDA unless "cpu" is named.

    In a process group (torchrun, parallel/mesh.init_process_group) every
    rank runs this.  With `dist: true` the trainer takes dist_mesh's mesh;
    every rank builds the same global batches from loaders at rank 0 of
    world 1, as the JAX package's one process per host does, and the
    trainer takes its rows, so the run equals the serial one.  Only rank 0
    writes the log file and metrics, runs the probe and the trace, and
    saves (the JAX package's main_proc)."""
    from reconfigisp_tpu_torch.data import create_dataset

    model = opt["model"] or ""
    if model not in ("isp", "darts", "darts_ft", "darts_yolo", "isp_yolo"):
        raise ValueError(f"unknown model {model!r}")
    dev = resolve_device(device if device is not None else opt.get("device"))
    name = opt.get("name", "run")
    paths = opt.get("path") or {}
    main_proc = meshlib.is_main_process()
    # a fresh run archives an existing experiment dir (reference
    # train.py:85-90); resume (the default) continues in place
    resume = opt["train"].get("resume", True) if opt.get("train") else True
    if not resume and paths.get("experiments_root") and main_proc:
        from reconfigisp_tpu_torch.utils.imaging import mkdir_and_rename
        mkdir_and_rename(paths["experiments_root"])
    if meshlib.world_size() > 1:
        torch.distributed.barrier()  # no rank writes before the rename
    log_dir = paths.get("log") if main_proc else None
    logger = setup_logger("base", log_dir, f"train_{name}", screen=main_proc)
    metrics = MetricsLogger(log_dir, use_tb=bool(opt.get("use_tb_logger")))

    train_opt = opt["train"]
    niter = int(max_iters or train_opt.get("niter", 100))
    seed = train_opt.get("manual_seed", 0) or 0
    generator = torch.Generator().manual_seed(seed)

    dataset_opt = dict(opt["datasets"]["train"])
    dataset_opt.setdefault("seed", seed)
    dataset = create_dataset(dataset_opt)
    batch_size = dataset_opt.get("batch_size", 4) or 4
    mesh = dist_mesh(batch_size) if opt.get("dist") else None

    # the measured per-op latency table, installed before any net reads it;
    # rank 0's on every rank, whose own timings would differ
    if train_opt.get("calibrate_latency"):
        from reconfigisp_tpu_torch.utils import latency as latlib
        table = [latlib.calibrate(
            size=int(train_opt.get("latency_calib_size") or 256), device=dev)
            if main_proc else None]
        if meshlib.world_size() > 1:
            torch.distributed.broadcast_object_list(table, src=0)
        table = table[0]
        latlib.install(table)
        logger.info("installed measured latency table: " + ", ".join(
            f"{k}={v:.3f}" for k, v in sorted(table.items())))
        if paths.get("experiments_root") and main_proc:
            os.makedirs(paths["experiments_root"], exist_ok=True)
            with open(os.path.join(paths["experiments_root"],
                                   "latency_table.json"), "w") as f:
                json.dump(table, f, indent=1)

    # the detection objective: a frozen YOLOv3 scores the ISP output
    # against the samples' "label" boxes
    criterion, target_key = None, "gt"
    if "yolo" in model:
        img_size = dataset_opt.get("data_size", 64) or 64
        criterion = make_yolo_criterion(
            build_yolo_evaluator(opt.get("yolo"), dev), img_size)
        target_key = "label"

    run = _run_search if model.startswith("darts") else _run_isp
    trainer, summary = run(opt, dataset, batch_size, niter, seed, generator,
                           dev, resume, logger, metrics,
                           criterion=criterion, target_key=target_key,
                           mesh=mesh, main_proc=main_proc)
    metrics.close()
    summary["steps"] = trainer.step_idx
    return summary


def _run_search(opt, dataset, batch_size, niter, seed, generator, dev,
                resume, logger, metrics, *, criterion, target_key, mesh,
                main_proc):
    """The darts, darts_ft and darts_yolo branch of run_training."""
    from reconfigisp_tpu_torch import config
    from reconfigisp_tpu_torch.data import create_search_loaders
    from reconfigisp_tpu_torch.data.datasets import set_access_base

    paths = opt.get("path") or {}
    train_opt = opt["train"]
    net = SuperNet(**config.supernet_kwargs(opt), device=dev)
    if opt["model"] == "darts_ft":
        trainer = DartsFtTrainer(net, train_opt,
                                 opt.get("proxy_ft_params") or {},
                                 generator=generator, mesh=mesh)
    else:
        trainer = DartsTrainer(net, train_opt, generator=generator,
                               criterion=criterion, target_key=target_key,
                               mesh=mesh)

    # resume if a training state exists
    start_epoch = 0
    state_dir = paths.get("training_state")
    if resume and state_dir:
        latest = checkpoint.latest_state(state_dir)
        if latest:
            start_epoch = trainer.resume(latest)
            logger.info(f"resumed from {latest} (step {trainer.step_idx}, "
                        f"epoch {start_epoch})")
            # crop-access counters past every draw of the run before
            set_access_base(dataset, trainer.step_idx * batch_size
                            + _probe_access_slack(opt, trainer.step_idx))

    # pretrained module weights (produced by search/proxy_pretrain.py)
    if paths.get("pretrain_proxies"):
        loaded = checkpoint.load_network(paths["pretrain_proxies"])
        names = trainer.load_pretrained(loaded)
        logger.info(f"pretrained weights installed for {sorted(names)}")
        missing = sorted(set(trainer.variables["omega"]) - set(names))
        if missing:
            logger.warning(
                f"pretrain_proxies checkpoint covers no weights for "
                f"{missing}: those modules enter the search untrained")

    # rank 0 of world 1 on every rank (the global batch; a mesh takes its
    # rows); a resumed run restarts the samplers at the saved epoch, as the
    # JAX package's does
    train_loader, val_loader = create_search_loaders(
        dataset, batch_size, seed=seed, start_epoch=start_epoch)
    per_epoch_steps = max(train_loader.sampler.per_epoch_len // batch_size, 1)
    resumed_step = trainer.step_idx

    def cur_epoch():
        return start_epoch + (trainer.step_idx - resumed_step) // per_epoch_steps

    logger_opt = opt.get("logger") or {}
    print_freq = logger_opt.get("print_freq", 10)
    save_freq = logger_opt.get("save_checkpoint_freq")
    val_freq = logger_opt.get("val_freq")
    # every rank draws the probe's samples, so the crop counters stay equal
    probe = _make_val_probe(opt, dataset, trainer,
                            is_yolo=target_key == "label")
    trace = _Trace(train_opt.get("trace_steps") if main_proc else None,
                   os.path.join(paths.get("experiments_root") or ".", "trace"),
                   dev, logger)
    # the checkpointed last metrics: a run that resumes complete runs no
    # step and reports its trained loss
    logs = dict(trainer.last_logs)
    iter_times: list = []
    first_loss = None
    loss_hist: list = []
    val_hist: list = []
    t0 = time.time()
    for (tb, vb) in zip(train_loader, val_loader):
        if trainer.step_idx >= niter:
            break
        trace.before(trainer.step_idx)
        t_step = time.time()
        logs = trainer.search_step(tb, vb)
        trace.after(trainer.step_idx, trainer.graph)
        if isinstance(trainer, DartsFtTrainer):
            trainer.record_intermediates(tb)
            if trainer.step_idx % trainer.ft_interval == 0:
                logs.update(trainer.finetune_proxies())
        iter_times.append(time.time() - t_step)
        if np.isfinite(logs.get("loss", np.nan)):
            loss_hist.append(float(logs["loss"]))
        if np.isfinite(logs.get("val_loss", np.nan)):
            val_hist.append(float(logs["val_loss"]))
        if first_loss is None and np.isfinite(logs.get("loss", np.nan)):
            first_loss = float(logs["loss"])
        if trainer.step_idx % print_freq == 0 and main_proc:
            dt = (time.time() - t0) / print_freq
            # pruned-path counts (reference train.py:286-287)
            pruned = trainer.pruned_paths(tb["noisy"][:1])
            logger.info(
                f"iter {trainer.step_idx:8,d} loss {logs['loss']:.4e} "
                f"val {logs['val_loss']:.4e} pruned {pruned.tolist()} "
                f"({dt:.3f}s/iter)")
            # per-slot alpha distributions (reference train.py:279-283)
            alpha_logs = {}
            for slot, arr in trainer.variables["alphas"].items():
                for m, a in enumerate(arr.detach().cpu().numpy()):
                    alpha_logs[f"alpha_{slot}/m_{m + 1}"] = float(a)
            for s, cnt in zip(trainer.net.slot_names, pruned):
                alpha_logs[f"pruned/{s}"] = float(cnt)
            metrics.scalars(trainer.step_idx, {**logs, **alpha_logs})
            t0 = time.time()
        if val_freq and trainer.step_idx % int(val_freq) == 0 and main_proc:
            logs.update(probe(trainer.step_idx))
            t0 = time.time()
        if save_freq and trainer.step_idx % int(save_freq) == 0 \
                and paths.get("models"):
            trainer.flush()  # on every rank: a dispatch is collective
            if main_proc:
                trainer.save(paths["models"], paths["training_state"],
                             cur_epoch())
    arch = trainer.architecture()
    logger.info(f"final architecture: {arch}")
    summary = {"architecture": arch, **logs,
               "steps_run": trainer.step_idx - resumed_step,
               **_timing_summary(iter_times),
               **_loss_window_summary(loss_hist),
               **_val_window_summary(val_hist),
               **_alpha_gap_summary(trainer.variables["alphas"])}
    if first_loss is not None:
        summary["loss_first"] = first_loss
    if paths.get("models") and main_proc:
        trainer.save(paths["models"], paths["training_state"], cur_epoch())
    return trainer, summary


def _run_isp(opt, dataset, batch_size, niter, seed, generator, dev, resume,
             logger, metrics, *, criterion, target_key, mesh, main_proc):
    """The isp and isp_yolo branch of run_training: step-2 training of a
    fixed pipeline."""
    from reconfigisp_tpu_torch.config import network_uses_proxy
    from reconfigisp_tpu_torch.data import create_loader
    from reconfigisp_tpu_torch.data.datasets import set_access_base

    paths = opt.get("path") or {}
    train_opt = opt["train"]
    net_opt = opt["network_G"]
    pipe = Pipeline(net_opt["architecture"],
                    use_proxy=network_uses_proxy(net_opt), device=dev,
                    generator=generator)
    trainer = IspTrainer(pipe, train_opt,
                         train_weights=bool(train_opt.get("train_weights")),
                         criterion=criterion, target_key=target_key,
                         mesh=mesh)
    # pretrained module weights: the shared bank, then per-step overrides
    # (reference isp_universal.py:169-176)
    if paths.get("pretrain_proxies"):
        loaded = checkpoint.load_network(paths["pretrain_proxies"])
        trainer.load_weights({name: w for name, w in loaded.items()
                              if name in pipe.weights})
    for step_name, wpath in (net_opt.get("module_weight_paths")
                             or {}).items():
        trainer.load_weights({step_name: checkpoint.load_network(wpath)})
    # resume after the installs, so a saved state wins over them
    state_dir = paths.get("training_state")
    if resume and state_dir:
        latest = checkpoint.latest_state(state_dir)
        if latest:
            trainer.resume(latest)
            logger.info(f"resumed from {latest} (step {trainer.step_idx})")
            set_access_base(dataset, trainer.step_idx * batch_size
                            + _probe_access_slack(opt, trainer.step_idx))
    resumed_step = trainer.step_idx
    # skip what the run before consumed: the stream continues where it
    # stopped
    loader = create_loader(dataset, batch_size, shuffle_seed=seed,
                           skip=trainer.step_idx * batch_size)
    per_rank = max(loader.sampler.per_epoch_len, 1)

    def cur_epoch():
        return (trainer.step_idx * batch_size) // per_rank

    logger_opt = opt.get("logger") or {}
    print_freq = logger_opt.get("print_freq", 10)
    save_freq = logger_opt.get("save_checkpoint_freq")
    val_freq = logger_opt.get("val_freq")
    probe = _make_val_probe(opt, dataset, trainer,
                            is_yolo=target_key == "label")
    # the same fixed samples scored before and after training (every rank
    # draws them, rank 0 scores them)
    start_probe = {f"{k}_start": v for k, v in probe(0).items()
                   if k in ("probe_loss", "val_psnr")} if main_proc else {}
    logs = dict(trainer.last_logs)
    iter_times = []
    first_loss = None
    loss_hist: list = []
    t0 = time.time()
    for batch in loader:
        if trainer.step_idx >= niter:
            break
        t_step = time.time()
        logs = trainer.train_step(batch)
        iter_times.append(time.time() - t_step)
        if np.isfinite(logs.get("loss", np.nan)):
            loss_hist.append(float(logs["loss"]))
        if first_loss is None and np.isfinite(logs.get("loss", np.nan)):
            first_loss = float(logs["loss"])
        if trainer.step_idx % print_freq == 0 and main_proc:
            dt = (time.time() - t0) / print_freq
            logger.info(f"iter {trainer.step_idx:8,d} "
                        f"loss {logs['loss']:.4e} ({dt:.3f}s/iter)")
            metrics.scalars(trainer.step_idx, logs)
            t0 = time.time()
        if val_freq and trainer.step_idx % int(val_freq) == 0 and main_proc:
            logs.update(probe(trainer.step_idx))
            t0 = time.time()
        if save_freq and trainer.step_idx % int(save_freq) == 0 \
                and paths.get("models") and main_proc:
            trainer.save(paths["models"], paths["training_state"],
                         cur_epoch())
    summary = dict(logs)
    summary["steps_run"] = trainer.step_idx - resumed_step
    summary.update(_timing_summary(iter_times))
    if first_loss is not None:
        summary["loss_first"] = first_loss
    summary.update(_loss_window_summary(loss_hist))
    summary.update(start_probe)
    if main_proc:
        summary.update({f"{k}_final": v for k, v in
                        probe(trainer.step_idx).items()
                        if k in ("probe_loss", "val_psnr")})
    if paths.get("models") and main_proc:
        trainer.save(paths["models"], paths["training_state"], cur_epoch())
    return trainer, summary

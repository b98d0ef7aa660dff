"""Multi-rank dry run: the port's counterpart of
__graft_entry__.dryrun_multichip (checks 1-4).

`dryrun_multichip(world, device)` spawns `world` ranks (parallel/launch)
over a (data, space) mesh shaped as JAX shapes it: space 2 for an even
world of 4 or more, else 1.  Each rank runs, on a global batch of
max(world, 2) 16x16 crops made from numpy seed 0:

  1. a proxy-mode supernet search step (n_step 2) through
     make_data_parallel_step;
  2. a native search step with the bilateral (srgb_count 7);
  3. the tile program (parallel/tiling): the batch's rows over data, the
     tile positions dealt over space, the output gathered over data,
     against the same program run alone on the rank;
  4. DartsFtTrainer at K = 2 with its replay memory and a tuning round, and
     a frozen-YOLO search step (tiny_test, 1 class).

Every check runs over that mesh: checks 1, 2 and 4 split the crops' height
over space through windows (parallel/space.py), check 3 deals the tile
positions over it.  Each check's loss must be finite and equal on every
rank.  -> rank 0's lines, the kernels' launches of each rank beside them.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np
import torch

from reconfigisp_tpu_torch.parallel import launch
from reconfigisp_tpu_torch.parallel import mesh as meshlib


def _mesh_space(world: int) -> int:
    return 2 if (world % 2 == 0 and world >= 4) else 1


def _launches() -> dict:
    from reconfigisp_tpu_torch.ops.kernels import bilateral, fastnlm, median
    return {m.__name__.rsplit(".", 1)[1]: m.launches
            for m in (bilateral, fastnlm, median)}


def _zero_launches() -> None:
    from reconfigisp_tpu_torch.ops.kernels import bilateral, fastnlm, median
    for m in (bilateral, fastnlm, median):
        m.launches = 0


def _checks(rank: int, world: int, device: str, out_dir: str) -> None:
    from reconfigisp_tpu_torch.parallel.dp import make_data_parallel_step
    from reconfigisp_tpu_torch.parallel.space import SpaceAxis, radius
    from reconfigisp_tpu_torch.parallel.tiling import tiled_apply
    from reconfigisp_tpu_torch.pipeline import Pipeline
    from reconfigisp_tpu_torch.search.darts import (
        DartsConfig, init_darts_opt_state, make_darts_step)
    from reconfigisp_tpu_torch.search.trainer import (
        DartsFtTrainer, DartsTrainer, build_yolo_evaluator,
        make_yolo_criterion)
    from reconfigisp_tpu_torch.supernet import SuperNet
    from reconfigisp_tpu_torch.utils import losses

    dev = torch.device(device)   # on CUDA, the rank's card is current
    space = _mesh_space(world)
    mesh = meshlib.make_mesh(world, space=space)
    group = mesh.get_group(meshlib.DATA_AXIS)
    rng = np.random.default_rng(0)
    n = max(world, 2)

    def mk(c, s=16):
        return rng.uniform(0.1, 0.9, (n, s, s, c)).astype(np.float32)

    lines, counts = [], []

    def record(what: str, value: float) -> None:
        got = torch.tensor([value], dtype=torch.float64)
        gathered = meshlib.all_gather(got, None)   # every rank of the mesh
        if not (np.isfinite(value) and bool((gathered == got).all())):
            raise AssertionError(f"{what}: {gathered.tolist()} over ranks")
        lines.append(f"{what}={value:.5f}")
        counts.append(_launches())

    def run_darts(net, batch):
        variables = meshlib.replicate(
            mesh, net.init(torch.Generator().manual_seed(0)))

        def forward(theta, alphas, omega, img):
            y, aux = net({"theta": theta, "alphas": alphas, "omega": omega},
                         img, return_aux=True)
            return y, aux["latency"]

        step = make_data_parallel_step(make_darts_step(
            forward, losses.make_criterion("l2"), DartsConfig(), group=group,
            space=SpaceAxis.of(mesh, radius(net))), mesh)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        _, _, logs = step(variables, init_darts_opt_state(variables), batch,
                          1.0)
        if not np.isfinite(float(logs["val_loss"])):
            raise AssertionError(f"val_loss {float(logs['val_loss'])}")
        return float(logs["loss"])

    pix = {"img": mk(1), "gt": mk(3), "val_img": mk(1), "val_gt": mk(3)}
    _zero_launches()
    # 1) proxy-mode search step
    record("proxy_darts loss", run_darts(
        SuperNet(2, 0.2, use_proxies=True, device=dev), pix))
    # 2) native search step through the bilateral (op 7)
    record("native_darts loss", run_darts(
        SuperNet(1, 0.2, srgb_count=7, device=dev), pix))

    # 3) the tile program: rows over data, positions over space, the
    # output gathered over data
    pipe = Pipeline("Bayer_02_Demosaic_02_sRGB_01_06", device=dev,
                    generator=torch.Generator().manual_seed(1))
    frames = torch.from_numpy(mk(1, 64)).to(dev)
    data_index, data_size, _, _ = meshlib.coordinate(mesh)
    rows = meshlib.shard_slices((n,), data_index, data_size, 0, 1)[0]
    with torch.no_grad():
        y = meshlib.all_gather(
            tiled_apply(pipe, frames[rows], patch=32, stride=24, chunk=2,
                        group=mesh.get_group(meshlib.SPACE_AXIS)),
            mesh.get_group(meshlib.DATA_AXIS))
        alone = tiled_apply(pipe, frames, patch=32, stride=24, chunk=2)
    if tuple(y.shape) != (n, 64, 64, 3) or not bool(torch.isfinite(y).all()):
        raise AssertionError(f"tiled output {tuple(y.shape)}")
    err = float((y - alone).abs().max())
    if err > 1e-5:
        raise AssertionError(f"tiled over the mesh vs alone: {err:.3e}")
    record("tiled_sp max_diff", err)

    # 4a) DartsFtTrainer at K = 2: both steps' intermediates in the memory
    ft_net = SuperNet(1, 0.2, use_proxies=True, srgb_count=4, device=dev)
    ft = DartsFtTrainer(ft_net, {"lr_G": 1e-3, "steps_per_dispatch": 2},
                        {"ft_steps": 1}, mesh=mesh,
                        generator=torch.Generator().manual_seed(0))
    tb = {"noisy": mk(1), "gt": mk(3)}
    vb = {"noisy": mk(1), "gt": mk(3)}
    ft.search_step(tb, vb)
    logs = ft.search_step(tb, vb)
    ft.record_intermediates(tb)
    if len(ft.ft_data) < 2 or ft.ft_data[0].shape[0] != n:
        raise AssertionError("the K-step dispatch lost the global batch's "
                             "intermediates")
    ft_logs = ft.finetune_proxies()
    if not ft_logs or not all(np.isfinite(v) for v in ft_logs.values()):
        raise AssertionError(f"finetune_proxies: {ft_logs}")
    record(f"darts_ft_k2 ft_ops={len(ft_logs)} loss", logs["loss"])

    # 4b) frozen-YOLO criterion search step
    ycrit = make_yolo_criterion(build_yolo_evaluator(
        {"cfg": "tiny_test", "classes": 1}, dev), 16)
    labels = np.zeros((n, 4, 6), np.float32)
    labels[:, 0] = [1.0, 0.0, 0.5, 0.5, 0.4, 0.4]
    ytr = DartsTrainer(SuperNet(1, 0.2, use_proxies=True, srgb_count=3,
                                device=dev),
                       {"lr_G": 1e-3}, mesh=mesh, criterion=ycrit,
                       target_key="label",
                       generator=torch.Generator().manual_seed(0))
    ylogs = ytr.search_step({"noisy": mk(1), "label": labels},
                            {"noisy": mk(1), "label": labels})
    record("yolo_darts loss", ylogs["loss"])

    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"lines": lines, "launches": counts,
                   "mesh": {"data": world // space, "space": space}}, f)


def dryrun_multichip(world: int, device="cpu") -> dict:
    """Checks 1-4 over `world` ranks on `device` -> {"lines": rank 0's
    check lines, "launches": [each rank's kernel launches after each
    check], "mesh": the tile program's mesh}.  Raises if a rank fails."""
    with tempfile.TemporaryDirectory() as tmp:
        launch.spawn(_checks, world, device=device,
                     init_file=os.path.join(tmp, "store"),
                     args=(world, str(device), tmp))
        ranks = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    return {"lines": ranks[0]["lines"], "mesh": ranks[0]["mesh"],
            "launches": [r["launches"] for r in ranks]}

"""The port's data parallelism over two gloo ranks on the CPU, against the
JAX package on one device.

One module fixture prepares the inputs here (numpy batches from seeds, the
JAX package's inits carried over by convert.supernet_variables_from_jax,
state_from_jax and yolo_weights_from_jax, a data_parallel=2 artifact),
launches two CPU ranks once (parallel/launch.spawn, a file store under the
test's tmp_path), computes the JAX package's results on the global batches
here while they run, and reads back what each rank wrote; each test
compares the two.
The ranks import this module to find their function: JAX is imported only
inside the functions that run in this process.

Cases and tolerances:
  * make_darts_step over the (2, 1) mesh (make_data_parallel_step), orders
    2 and 1, and the K = 3 multi-step against three sequential JAX steps,
    at tests/test_parallel.py's setup (SuperNet(1, 0.2, srgb_count=4),
    batch 8 of 16x16, rates 1e-2) and tolerances: loss 1e-4 relative,
    alphas and theta 1e-5;
  * make_data_parallel_apply of the supernet: 2e-5 (test_parallel.py);
  * IspTrainer over the mesh, 3 steps of batch 4 of 32x32 on the flagship
    and on slice 2 (median and fast-NLM): tests/test_torch_train.py's
    losses 1e-5 relative and logits 1e-5;
  * a frozen-YOLO search step (tiny_test, one class, batch 4 of 32x32)
    with every box in the first rank's rows, so the second rank has none:
    the JAX DartsTrainer on the whole batch, loss 1e-5 relative, alphas
    and theta 1e-5 (tests/test_torch_yolo_run_training.py);
  * DartsFtTrainer at K = 2 over the mesh, 2 steps and a tuning round:
    each rank's replay memory within 1e-6 of the serial port trainer's
    (the same convolutions on 2 rows instead of 4) and its tuned proxies
    within 1e-5 (Adam steps of lr 1e-3 on gradients that differ by that
    rounding), both ranks' tuned proxies equal;
  * tiled_apply with its positions dealt over a (1, 2) space group against
    JAX's tiled_apply: 1e-4, a pipeline's tolerance
    (tests/test_torch_pipeline.py);
  * a data_parallel=2 artifact served by both ranks against
    make_serving_fn on the whole batch: 1e-6 (the same program on fewer
    rows); loaded without a group it raises;
  * IspTrainer over a (1, 2) mesh, the space axis on whole frames, 2 steps
    of the flagship (fault F5 in ROADMAP.md: each rank stepped on its own
    half frame): each rank's logits equal the other's and the JAX
    trainer's within 1e-5, its losses within 1e-5 relative;
  * dryrun_multichip(2, "cpu"): its four checks run.
"""

import os
import pickle
import threading

import numpy as np
import pytest
import torch

import reconfigisp_tpu_torch as rt
from reconfigisp_tpu_torch import convert, deploy
from reconfigisp_tpu_torch.parallel import launch
from reconfigisp_tpu_torch.parallel import mesh as meshlib
from reconfigisp_tpu_torch.parallel.dp import (
    make_data_parallel_apply, make_data_parallel_step)
from reconfigisp_tpu_torch.parallel.dryrun import dryrun_multichip
from reconfigisp_tpu_torch.parallel.tiling import tiled_apply
from reconfigisp_tpu_torch.search import DartsFtTrainer, DartsTrainer, IspTrainer
from reconfigisp_tpu_torch.search.darts import (
    DartsConfig, init_darts_opt_state, make_darts_multi_step, make_darts_step)
from reconfigisp_tpu_torch.search.trainer import make_yolo_criterion
from reconfigisp_tpu_torch.supernet import SuperNet
from reconfigisp_tpu_torch.utils import losses
from reconfigisp_tpu_torch.yolo import cfg as ycfg
from reconfigisp_tpu_torch.yolo.net import YoloNet
from torch_one_thread import one_thread  # noqa: F401  (autouse)

FLAGSHIP = "Bayer_01_Demosaic_03_sRGB_01_13_11"
SLICE2 = "Bayer_01_Demosaic_03_sRGB_08_09_01_13_11"
TILED_ARCH = "Bayer_02_Demosaic_02_sRGB_01_06"
CFG = dict(lr_theta=1e-2, lr_alpha=1e-2, lr_meta=1e-2)
ISP_OPT = {"lr_G": 1e-3, "beta1": 0.9, "beta2": 0.99,
           "pixel_criterion": "l2", "lr_scheme": "MultiStepLR",
           "lr_steps": [2], "lr_gamma": 0.5}
YOLO_OPT = {"lr_G": 1e-3, "momentum_G": 0.9, "lr_meta": 1e-3, "beta1": 0.9,
            "beta2": 0.99, "darts_order": 1}
FT_OPT = {"lr_G": 1e-3, "steps_per_dispatch": 2, "manual_seed": 3}
TILING = dict(patch=32, stride=24, chunk=2)


def _uniform(rng, shape, lo=0.1, hi=0.9):
    return rng.uniform(lo, hi, shape).astype(np.float32)


def _darts_batch(rng, n=8, s=16):
    return {"img": _uniform(rng, (n, s, s, 1)), "gt": _uniform(rng, (n, s, s, 3)),
            "val_img": _uniform(rng, (n, s, s, 1)),
            "val_gt": _uniform(rng, (n, s, s, 3))}


def _inputs() -> dict:
    """Every batch, from numpy seeds."""
    rng = np.random.default_rng(0)
    labels = np.zeros((4, 3, 6), np.float32)
    labels[0, 0] = [1.0, 0.0, 0.5, 0.5, 0.4, 0.3]
    labels[1, 0] = [1.0, 0.0, 0.3, 0.6, 0.2, 0.5]
    labels[1, 1] = [1.0, 0.0, 0.7, 0.2, 0.3, 0.3]
    return {
        "darts": _darts_batch(rng),
        "multi": [_darts_batch(rng) for _ in range(3)],
        "apply_x": _uniform(rng, (8, 16, 16, 1)),
        "isp": [{"noisy": _uniform(rng, (4, 32, 32, 1), 0.02, 0.6),
                 "gt": _uniform(rng, (4, 32, 32, 3), 0.05, 0.95)}
                for _ in range(3)],
        "yolo": ({"noisy": _uniform(rng, (4, 32, 32, 1)), "label": labels},
                 {"noisy": _uniform(rng, (4, 32, 32, 1)), "label": labels}),
        "ft": [({"noisy": _uniform(rng, (4, 16, 16, 1)),
                 "gt": _uniform(rng, (4, 16, 16, 3))},
                {"noisy": _uniform(rng, (4, 16, 16, 1)),
                 "gt": _uniform(rng, (4, 16, 16, 3))}) for _ in range(2)],
        "tiled_x": _uniform(rng, (2, 64, 64, 1)),
        "serve_x": _uniform(rng, (4, 32, 32, 1)),
    }


# ------------------------------------------------------------- the ranks

def _net(**kw):
    return SuperNet(1, 0.2, device="cpu", **kw)


def _forward(net):
    def fwd(theta, alphas, omega, img):
        return net({"theta": theta, "alphas": alphas, "omega": omega},
                   img), 0.0
    return fwd


def _l2(pred, target, latency=None, group=None):
    return losses.l2(pred, target, group)


def _tensors(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _vars_out(variables):
    back = convert.supernet_variables_to_jax(variables)
    return {"alphas": back["alphas"], "theta": back["theta"]}


def _darts_runs(share, mesh, group):
    """Orders 2 and 1, one step each, and the K = 3 multi-step."""
    net = _net(srgb_count=4)
    out = {}
    for order in (2, 1):
        v = convert.supernet_variables_from_jax(share["supernet"], net)
        step = make_data_parallel_step(make_darts_step(
            _forward(net), _l2, DartsConfig(order=order, **CFG), group=group),
            mesh)
        v, _, logs = step(v, init_darts_opt_state(v),
                          _tensors(share["inputs"]["darts"]), 1.0)
        out[f"order{order}"] = (_vars_out(v),
                                {k: float(x) for k, x in logs.items()})
    v = convert.supernet_variables_from_jax(share["supernet"], net)
    multi = make_data_parallel_step(make_darts_multi_step(make_darts_step(
        _forward(net), _l2, DartsConfig(**CFG), group=group), group=group),
        mesh)
    stacked = {k: torch.stack([torch.from_numpy(b[k])
                               for b in share["inputs"]["multi"]])
               for k in share["inputs"]["multi"][0]}
    v, _, logs = multi(v, init_darts_opt_state(v), stacked,
                       torch.ones(3))
    out["multi"] = (_vars_out(v), {k: float(x) for k, x in logs.items()
                                   if not k.startswith("_")})
    v = convert.supernet_variables_from_jax(share["supernet"], net)
    with torch.no_grad():
        out["apply"] = make_data_parallel_apply(
            lambda vv, x: net(vv, x), mesh)(
            v, torch.from_numpy(share["inputs"]["apply_x"])).numpy()
    return out


def _isp_runs(share, mesh):
    out = {}
    for arch in (FLAGSHIP, SLICE2):
        pipe = rt.Pipeline(arch, device="cpu").load_state(
            convert.state_from_jax(share["isp_state"][arch]))
        trainer = IspTrainer(pipe, ISP_OPT, mesh=mesh)
        losses_, logits = [], []
        for batch in share["inputs"]["isp"]:
            losses_.append(trainer.train_step(batch)["loss"])
            logits.append(convert.state_to_jax(pipe)["logits"])
        out[arch] = (losses_, logits)
    return out


def _yolo_run(share, mesh):
    blocks = ycfg.yolov3_tiny_test_blocks(num_classes=1)
    ynet = convert.yolo_weights_from_jax(share["yolo_weights"],
                                         YoloNet(blocks))
    net = _net(srgb_count=4)
    trainer = DartsTrainer(net, YOLO_OPT, mesh=mesh,
                           criterion=make_yolo_criterion(ynet, 32),
                           target_key="label")
    trainer._assign(convert.supernet_variables_from_jax(
        share["yolo_supernet"], net), trainer.opt_state)
    logs = trainer.search_step(*share["inputs"]["yolo"])
    return _vars_out(trainer.variables), logs


def _ft_run(share, mesh):
    """The mesh trainer and, on this rank alone, the serial one: 2 steps
    at K = 2, recorded, and a tuning round."""
    runs = []
    for m in (mesh, None):
        net = _net(srgb_count=4, use_proxies=True)
        trainer = DartsFtTrainer(net, FT_OPT, {"ft_steps": 2}, mesh=m)
        trainer._assign(convert.supernet_variables_from_jax(
            share["ft_supernet"], net), trainer.opt_state)
        for tb, vb in share["inputs"]["ft"]:
            trainer.search_step(tb, vb)
            trainer.record_intermediates(tb)
        trainer.finetune_proxies()
        runs.append(trainer)
    mesh_t, serial = runs
    memory = max(float((a - b).abs().max())
                 for a, b in zip(mesh_t.ft_data, serial.ft_data))
    omega = max(float((a - b).abs().max())
                for s in mesh_t.ft_ops
                for a, b in zip(mesh_t.variables["omega"][s.name].parameters(),
                                serial.variables["omega"][s.name].parameters()))
    tuned = {s.name: [p.detach().clone() for p in
                      mesh_t.variables["omega"][s.name].parameters()]
             for s in mesh_t.ft_ops}
    return {"memory_len": (len(mesh_t.ft_data), len(serial.ft_data)),
            "memory_diff": memory, "omega_diff": omega, "tuned": tuned,
            "mids_rows": mesh_t.ft_data[0].shape[0]}


def _isp_space_run(share):
    """F5: the flagship over the (1, 2) mesh, 2 steps."""
    mesh = meshlib.make_mesh(2, space=2)
    pipe = rt.Pipeline(FLAGSHIP, device="cpu").load_state(
        convert.state_from_jax(share["isp_state"][FLAGSHIP]))
    trainer = IspTrainer(pipe, ISP_OPT, mesh=mesh)
    losses_, logits = [], []
    for batch in share["inputs"]["isp"][:2]:
        losses_.append(trainer.train_step(batch)["loss"])
        logits.append(convert.state_to_jax(pipe)["logits"])
    return losses_, logits


def _tiled_run(share):
    mesh = meshlib.make_mesh(2, space=2)
    pipe = rt.Pipeline(TILED_ARCH, device="cpu").load_state(
        convert.state_from_jax(share["tiled_state"]))
    with torch.no_grad():
        return tiled_apply(pipe, torch.from_numpy(share["inputs"]["tiled_x"]),
                           group=mesh.get_group(meshlib.SPACE_AXIS),
                           **TILING).numpy()


def _ranks(rank: int, root: str) -> None:
    """Every check of one rank; the results go to <root>/rank<r>.pkl."""
    with open(os.path.join(root, "share.pkl"), "rb") as f:
        share = pickle.load(f)
    mesh = meshlib.make_mesh()
    group = mesh.get_group(meshlib.DATA_AXIS)
    out = {"mesh": (tuple(mesh.shape), mesh.mesh_dim_names,
                    tuple(meshlib.make_mesh(2, space=2).shape))}
    out.update(_darts_runs(share, mesh, group))
    out["isp"] = _isp_runs(share, mesh)
    out["yolo"] = _yolo_run(share, mesh)
    out["ft"] = _ft_run(share, mesh)
    out["tiled"] = _tiled_run(share)
    out["isp_space"] = _isp_space_run(share)
    served = deploy.load_pipeline(os.path.join(root, "dp2.rispt"),
                                  device="cpu")
    out["served"] = served(share["inputs"]["serve_x"]).numpy()
    with open(os.path.join(root, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


# ------------------------------------------------------- this process

def _share(inputs):
    """The inits both packages start from: the port's, seeded, in the JAX
    layout (convert's *_to_jax), which the ranks carry back with convert's
    *_from_jax."""
    from reconfigisp_tpu_torch.yolo.net import init_yolo

    def supernet(seed, **kw):
        return convert.supernet_variables_to_jax(
            _net(srgb_count=4, **kw).init(torch.Generator().manual_seed(seed)))

    def pipeline(arch, seed):
        return convert.state_to_jax(rt.Pipeline(
            arch, device="cpu", generator=torch.Generator().manual_seed(seed)))

    blocks = ycfg.yolov3_tiny_test_blocks(num_classes=1)
    return {
        "supernet": supernet(0),
        "yolo_supernet": supernet(1),
        "ft_supernet": supernet(2, use_proxies=True),
        "isp_state": {arch: pipeline(arch, 0) for arch in (FLAGSHIP, SLICE2)},
        "tiled_state": pipeline(TILED_ARCH, 1),
        "yolo_weights": convert.yolo_weights_to_jax(
            init_yolo(blocks, torch.Generator().manual_seed(7))),
        "inputs": inputs,
    }


def _jax_references(share) -> dict:
    """The JAX package on the whole batches, from the same inits."""
    import jax
    import jax.numpy as jnp

    import reconfigisp_tpu as rj
    import reconfigisp_tpu.search.trainer as jtrainer
    from reconfigisp_tpu.parallel.tiling import tiled_apply as jtiled
    from reconfigisp_tpu.yolo import cfg as jcfg
    from reconfigisp_tpu.search.darts import (
        DartsConfig as JaxDartsConfig, init_darts_opt_state as jinit,
        make_darts_step as jstep)
    from reconfigisp_tpu.supernet import SuperNet as JaxSuperNet
    from reconfigisp_tpu.utils import losses as jlosses
    from reconfigisp_tpu.utils.checkpoint import _to_numpy

    inputs = share["inputs"]
    ref = {}
    jnet = JaxSuperNet(1, 0.2, srgb_count=4)

    def fwd(theta, alphas, omega, img):
        return jnet({"theta": theta, "alphas": alphas, "omega": omega},
                    img), 0.0

    def crit(p, t, latency=None):
        return jlosses.l2(p, t)

    v0 = jax.tree.map(jnp.asarray, share["supernet"])
    batch = {k: jnp.asarray(v) for k, v in inputs["darts"].items()}
    with jax.default_matmul_precision("highest"):
        for order in (2, 1):
            step = jax.jit(jstep(fwd, crit, JaxDartsConfig(order=order, **CFG)))
            v, _, logs = step(v0, jinit(v0), batch, 1.0)
            ref[f"order{order}"] = (_to_numpy(v), {k: float(x) for k, x in
                                                   logs.items()})
            if order == 2:
                v, o = v0, jinit(v0)
                for b in inputs["multi"]:
                    v, o, logs = step(v, o, {k: jnp.asarray(a) for k, a in
                                             b.items()}, 1.0)
                ref["multi"] = (_to_numpy(v), {k: float(x) for k, x in
                                               logs.items()})
        ref["apply"] = np.asarray(jax.jit(jnet)(v0, jnp.asarray(
            inputs["apply_x"])))

        for arch in (FLAGSHIP, SLICE2):
            jt = jtrainer.IspTrainer(rj.Pipeline(arch), ISP_OPT)
            jt.state = jax.tree.map(jnp.asarray, share["isp_state"][arch])
            losses_, logits = [], []
            for b in inputs["isp"]:
                losses_.append(jt.train_step(b)["loss"])
                logits.append(_to_numpy(jt.state["logits"]))
            ref[arch] = (losses_, logits)

        # the step JAX's DartsTrainer builds from YOLO_OPT, at its first
        # step's lr scale (1)
        ycrit = jtrainer.make_yolo_criterion(
            jcfg.yolov3_tiny_test_blocks(num_classes=1),
            jax.tree.map(jnp.asarray, share["yolo_weights"]), 32)
        def yforward(theta, alphas, omega, img):
            y, aux = jnet({"theta": theta, "alphas": alphas, "omega": omega},
                          img, return_aux=True)
            return y, aux["latency"]

        ystep = jax.jit(jstep(
            yforward, ycrit, JaxDartsConfig(lr_theta=1e-3, lr_alpha=1e-3, lr_meta=1e-3,
                                  order=1)))
        tb, vb = inputs["yolo"]
        yv = jax.tree.map(jnp.asarray, share["yolo_supernet"])
        yv, _, ylogs = ystep(yv, jinit(yv), {
            "img": jnp.asarray(tb["noisy"]), "gt": jnp.asarray(tb["label"]),
            "val_img": jnp.asarray(vb["noisy"]),
            "val_gt": jnp.asarray(vb["label"])}, 1.0)
        ref["yolo"] = (_to_numpy(yv), {k: float(x) for k, x in ylogs.items()})

        state = jax.tree.map(jnp.asarray, share["tiled_state"])
        pipe = rj.Pipeline(TILED_ARCH)
        ref["tiled"] = np.asarray(jtiled(lambda pp: pipe(state, pp),
                                         jnp.asarray(inputs["tiled_x"]),
                                         **TILING))
    return ref


def _serving_artifact(share, root):
    """The flagship exported whole-frame for 2 ranks, and
    make_serving_fn's output on the whole batch."""
    pipe = rt.Pipeline(FLAGSHIP, device="cpu",
                       generator=torch.Generator().manual_seed(2))
    blob = deploy.export_pipeline(pipe, share["inputs"]["serve_x"].shape,
                                  data_parallel=2)
    path = os.path.join(root, "dp2.rispt")
    deploy.save_artifact(path, blob)
    want = deploy.make_serving_fn(pipe, device="cpu")(
        share["inputs"]["serve_x"]).numpy()
    return pipe, path, want


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp")
    share = _share(_inputs())
    with open(root / "share.pkl", "wb") as f:
        pickle.dump(share, f)
    pipe, artifact, served_want = _serving_artifact(share, str(root))
    # the ranks (one thread each), then the dry run's, run while JAX
    # computes its references
    failed, dryrun = [], []

    def ranks_main():
        try:
            launch.spawn(_ranks, 2, device="cpu",
                         init_file=str(root / "store"), args=(str(root),))
            dryrun.append(dryrun_multichip(2, "cpu"))
        except Exception as err:  # noqa: BLE001 - reraised below
            failed.append(err)

    runner = threading.Thread(target=ranks_main)
    runner.start()
    try:
        ref = _jax_references(share)
    finally:
        runner.join(timeout=600)
    assert not runner.is_alive()
    if failed:
        raise failed[0]
    ranks = []
    for r in range(2):
        with open(root / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return {"ranks": ranks, "ref": ref, "dryrun": dryrun[0],
            "start": share["supernet"], "pipe": pipe, "artifact": artifact,
            "served": served_want}


def _assert_vars(got, want, alpha_atol=1e-5, theta_atol=1e-5):
    for slot, a in want["alphas"].items():
        np.testing.assert_allclose(got["alphas"][slot], a, rtol=0,
                                   atol=alpha_atol, err_msg=slot)
    for slot, ops in want["theta"].items():
        for op, t in ops.items():
            np.testing.assert_allclose(got["theta"][slot][op], t, rtol=0,
                                       atol=theta_atol, err_msg=f"{slot} {op}")


# ------------------------------------------------------------------ tests

def test_meshes_of_two_ranks(dp):
    for rank in dp["ranks"]:
        assert rank["mesh"] == ((2, 1), ("data", "space"), (1, 2))


@pytest.mark.parametrize("case", ["order2", "order1", "multi"])
def test_darts_step_over_the_mesh_matches_jax(dp, case):
    """Each rank's variables and global logs after the data-parallel step
    (K = 3 steps for multi) equal JAX's single-device ones."""
    want_vars, want_logs = dp["ref"][case]
    for rank in dp["ranks"]:
        got_vars, got_logs = rank[case]
        for k in ("loss", "val_loss"):
            assert got_logs[k] == pytest.approx(want_logs[k], rel=1e-4), k
        _assert_vars(got_vars, want_vars)
    start = dp["start"]["alphas"]
    moved = max(float(np.abs(a - start[s]).max())
                for s, a in want_vars["alphas"].items())
    assert moved > 1e-4  # the alphas compared did not stand still


def test_data_parallel_apply_matches_jax(dp):
    for rank in dp["ranks"]:
        np.testing.assert_allclose(rank["apply"], dp["ref"]["apply"],
                                   atol=2e-5, rtol=0)


@pytest.mark.parametrize("arch", [FLAGSHIP, SLICE2],
                         ids=["flagship", "slice2"])
def test_isp_trainer_over_the_mesh_matches_jax(dp, arch):
    """3 steps, the schedule halving the lr at step 2: the global loss of
    each step and the logits after it."""
    want_losses, want_logits = dp["ref"][arch]
    for rank in dp["ranks"]:
        got_losses, got_logits = rank["isp"][arch]
        np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5)
        for got, want in zip(got_logits, want_logits):
            for name in want:
                np.testing.assert_allclose(got[name], want[name], atol=1e-5,
                                           rtol=0, err_msg=name)


def test_isp_trainer_over_a_space_mesh_matches_jax(dp):
    """F5: over a (1, 2) mesh both ranks step on the whole frame's
    gradient (each runs its window and the criterion sees the gathered
    frame), so their losses and logits equal JAX's single-device
    trainer's after each of 2 steps, and the ranks' logits are equal."""
    want_losses, want_logits = dp["ref"][FLAGSHIP]
    got = [rank["isp_space"] for rank in dp["ranks"]]
    for got_losses, got_logits in got:
        np.testing.assert_allclose(got_losses, want_losses[:2], rtol=1e-5)
        for step, want in enumerate(want_logits[:2]):
            for name in want:
                np.testing.assert_allclose(got_logits[step][name], want[name],
                                           atol=1e-5, rtol=0,
                                           err_msg=f"step {step} {name}")
    for step in range(2):   # one state on every rank, bit for bit
        for name in want_logits[0]:
            np.testing.assert_array_equal(got[0][1][step][name],
                                          got[1][1][step][name])


def test_yolo_search_step_with_boxes_in_one_shard_matches_jax(dp):
    """Boxes in images 0-1 only: the second rank's shard has none, and the
    global object count and gate give JAX's whole-batch step."""
    want_vars, want_logs = dp["ref"]["yolo"]
    for rank in dp["ranks"]:
        got_vars, got_logs = rank["yolo"]
        for k in ("loss", "val_loss"):
            assert got_logs[k] == pytest.approx(want_logs[k], rel=1e-5), k
        _assert_vars(got_vars, want_vars)


def test_ft_trainer_over_the_mesh_keeps_the_serial_memory(dp):
    """K = 2, 2 steps recorded and a tuning round: each rank's memory holds
    the whole batch's intermediates, as the serial trainer's; the tuned
    proxies agree with the serial ones and between the ranks."""
    for rank in dp["ranks"]:
        ft = rank["ft"]
        assert ft["memory_len"][0] == ft["memory_len"][1] > 0
        assert ft["mids_rows"] == 4
        assert ft["memory_diff"] <= 1e-6
        assert ft["omega_diff"] <= 1e-5
    a, b = (r["ft"]["tuned"] for r in dp["ranks"])
    for name in a:
        for x, y in zip(a[name], b[name]):
            assert torch.equal(x, y), name


def test_tiled_apply_over_a_space_group_matches_jax(dp):
    for rank in dp["ranks"]:
        np.testing.assert_allclose(rank["tiled"], dp["ref"]["tiled"],
                                   atol=1e-4, rtol=0)


def test_data_parallel_artifact_served_by_two_ranks(dp):
    """Each rank serves its 2 rows and gathers the 4; loaded without a
    group of 2 ranks the artifact raises, as JAX's does with too few
    devices (a space axis's: tests/test_torch_deploy.py::test_mesh_raises,
    served over four ranks: tests/test_torch_space.py)."""
    header = deploy.split_artifact(open(dp["artifact"], "rb").read())[0]
    assert header["mesh"] == {"data": 2, "space": 1}
    assert header["input_shape"] == [4, 32, 32, 1]
    for rank in dp["ranks"]:
        np.testing.assert_allclose(rank["served"], dp["served"], atol=1e-6,
                                   rtol=0)
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        deploy.load_pipeline(dp["artifact"], device="cpu")
    with pytest.raises(ValueError, match="do not"):
        deploy.export_pipeline(dp["pipe"], (3, 32, 32, 1), data_parallel=2)


def test_dryrun_multichip_on_two_cpu_ranks(dp):
    out = dp["dryrun"]
    assert out["mesh"] == {"data": 2, "space": 1}
    names = [line.rsplit("=", 1)[0] for line in out["lines"]]
    assert names == ["proxy_darts loss", "native_darts loss",
                     "tiled_sp max_diff", "darts_ft_k2 ft_ops=3 loss",
                     "yolo_darts loss"]
    assert len(out["launches"]) == 2

"""The port's space axis on whole frames over four gloo ranks on the CPU, a
(2, 2) mesh, against the JAX package on one device.

As in tests/test_torch_dp.py, one module fixture prepares the inputs here
(numpy batches from seeds, the port's seeded inits in the JAX layout, a
data 2 x space 2 artifact), launches the four ranks once
(parallel/launch.spawn), computes the JAX package's results on the global
batches here while they run, and reads back what each rank wrote.  Every
rank takes its images over data and its window of their frames over space
(parallel/space.py); the windows are whole frames where the network's
row radius reaches past them, as at the search crops.

Cases and tolerances:
  1. make_data_parallel_apply of SuperNet(1, 0.2, srgb_count=4) on 4 of
     32x32: 2e-5 (tests/test_parallel.py::test_spatial_sharding_executes);
  2. whole-frame pipelines on 2 of 128x32, each rank on a window shorter
     than the frame, at 1e-4 (tests/test_torch_pipeline.py): the
     flagship, slice 2 (median and fast-NLM, their plain forms here) and a
     pipeline of global ops (grayworld, whiteworld, reinhard, the
     conditional gamma);
  3. a data 2 x space 2 artifact of Bayer_02_Demosaic_03_sRGB_06_02 served
     on 8 of 32x32: 1e-5 against the port's make_serving_fn on the whole
     batch (the same convolutions on a window), 1e-4 against JAX's pipe;
  4. make_darts_step at tests/test_parallel.py's setup (batch 8 of 16x16,
     rates 1e-2): order 2 at srgb_count=4, order 1 at srgb_count=7, where
     grayworld, whiteworld and the bilateral are candidates: loss 1e-4
     relative, alphas and theta 1e-5;
  5. IspTrainer, 3 steps of batch 4 of 32x32, flagship and slice 2:
     losses 1e-5 relative, logits 1e-5 (tests/test_torch_train.py);
  6. a frozen-YOLO search step (tiny_test, one class, boxes in the first
     data rank's images only): loss 1e-5 relative, alphas and theta 1e-5;
  7. DartsFtTrainer at K = 2, 2 steps and a tuning round: each rank's
     replay memory within 1e-6 of the serial port trainer's and its tuned
     proxies within 1e-5 (tests/test_torch_dp.py);
  8. every rank ends each run with one state, bit for bit;
  9. dryrun_multichip(4, "cpu"): its four checks over the (2, 2) mesh.
The ranks import this module to find their function: JAX is imported only
inside the functions that run in this process.
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
from reconfigisp_tpu_torch.parallel import space
from reconfigisp_tpu_torch.parallel.dp import (
    make_data_parallel_apply, make_data_parallel_step)
from reconfigisp_tpu_torch.parallel.dryrun import dryrun_multichip
from reconfigisp_tpu_torch.search import DartsFtTrainer, DartsTrainer, IspTrainer
from reconfigisp_tpu_torch.search.darts import (
    DartsConfig, init_darts_opt_state, make_darts_step)
from reconfigisp_tpu_torch.search.trainer import make_yolo_criterion
from reconfigisp_tpu_torch.supernet import SuperNet
from reconfigisp_tpu_torch.utils import losses
from reconfigisp_tpu_torch.yolo import cfg as ycfg
from reconfigisp_tpu_torch.yolo.net import YoloNet
from torch_one_thread import one_thread  # noqa: F401  (autouse)

WORLD = 4
FLAGSHIP = "Bayer_01_Demosaic_03_sRGB_01_13_11"
SLICE2 = "Bayer_01_Demosaic_03_sRGB_08_09_01_13_11"
GLOBAL = "Bayer_02_Demosaic_03_sRGB_05_06_02_16"
SERVED = "Bayer_02_Demosaic_03_sRGB_06_02"
PIPES = (FLAGSHIP, SLICE2, GLOBAL)
DARTS = {"order2": (2, 4), "order1_srgb7": (1, 7)}   # case -> order, srgb
CFG = dict(lr_theta=1e-2, lr_alpha=1e-2, lr_meta=1e-2)
ISP_OPT = {"lr_G": 1e-3, "beta1": 0.9, "beta2": 0.99,
           "pixel_criterion": "l2", "lr_scheme": "MultiStepLR",
           "lr_steps": [2], "lr_gamma": 0.5}
YOLO_OPT = {"lr_G": 1e-3, "momentum_G": 0.9, "lr_meta": 1e-3, "beta1": 0.9,
            "beta2": 0.99, "darts_order": 1}
FT_OPT = {"lr_G": 1e-3, "steps_per_dispatch": 2, "manual_seed": 3}


def _uniform(rng, shape, lo=0.1, hi=0.9):
    return rng.uniform(lo, hi, shape).astype(np.float32)


def _inputs() -> dict:
    rng = np.random.default_rng(1)
    labels = np.zeros((4, 3, 6), np.float32)
    labels[0, 0] = [1.0, 0.0, 0.5, 0.5, 0.4, 0.3]
    labels[1, 0] = [1.0, 0.0, 0.3, 0.6, 0.2, 0.5]
    labels[1, 1] = [1.0, 0.0, 0.7, 0.2, 0.3, 0.3]
    s = 16
    return {
        "apply_x": _uniform(rng, (4, 32, 32, 1)),
        "pipe_x": _uniform(rng, (2, 128, 32, 1), 0.02, 0.9),
        "serve_x": _uniform(rng, (8, 32, 32, 1)),
        "darts": {"img": _uniform(rng, (8, s, s, 1)),
                  "gt": _uniform(rng, (8, s, s, 3)),
                  "val_img": _uniform(rng, (8, s, s, 1)),
                  "val_gt": _uniform(rng, (8, s, s, 3))},
        "isp": [{"noisy": _uniform(rng, (4, 32, 32, 1), 0.02, 0.6),
                 "gt": _uniform(rng, (4, 32, 32, 3), 0.05, 0.95)}
                for _ in range(3)],
        "yolo": ({"noisy": _uniform(rng, (4, 32, 32, 1)), "label": labels},
                 {"noisy": _uniform(rng, (4, 32, 32, 1)), "label": labels}),
        "ft": [({"noisy": _uniform(rng, (4, 16, 16, 1)),
                 "gt": _uniform(rng, (4, 16, 16, 3))},
                {"noisy": _uniform(rng, (4, 16, 16, 1)),
                 "gt": _uniform(rng, (4, 16, 16, 3))}) for _ in range(2)],
    }


# ------------------------------------------------------------- the ranks

def _net(srgb_count, **kw):
    return SuperNet(1, 0.2, srgb_count=srgb_count, device="cpu", **kw)


def _forward(net):
    def fwd(theta, alphas, omega, img):
        return net({"theta": theta, "alphas": alphas, "omega": omega},
                   img), 0.0
    return fwd


def _l2(pred, target, latency=None, group=None):
    return losses.l2(pred, target, group)


def _vars_out(variables):
    back = convert.supernet_variables_to_jax(variables)
    return {"alphas": back["alphas"], "theta": back["theta"]}


def _pipeline(share, arch):
    return rt.Pipeline(arch, device="cpu").load_state(
        convert.state_from_jax(share["pipes"][arch]))


def _rank_applies(share, mesh):
    net = _net(4)
    v = convert.supernet_variables_from_jax(share["supernet"][4], net)
    out = {}
    with torch.no_grad():
        out["apply"] = make_data_parallel_apply(
            lambda vv, x: net(vv, x), mesh, halo=space.radius(net))(
            v, torch.from_numpy(share["inputs"]["apply_x"])).numpy()
        x = torch.from_numpy(share["inputs"]["pipe_x"])
        for arch in PIPES:
            pipe = _pipeline(share, arch)
            halo = space.radius(pipe)
            out[arch] = make_data_parallel_apply(
                lambda vv, xx: pipe(xx), mesh, halo=halo)(None, x).numpy()
            out[f"{arch} window"] = space.SpaceAxis.of(mesh, halo).window(
                x.shape[1]).rows
    served = deploy.load_pipeline(share["artifact"], device="cpu")
    out["served"] = served(share["inputs"]["serve_x"]).numpy()
    return out


def _rank_darts(share, mesh):
    group = mesh.get_group(meshlib.DATA_AXIS)
    out = {}
    for case, (order, srgb) in DARTS.items():
        net = _net(srgb)
        v = convert.supernet_variables_from_jax(share["supernet"][srgb], net)
        step = make_data_parallel_step(make_darts_step(
            _forward(net), _l2, DartsConfig(order=order, **CFG), group=group,
            space=space.SpaceAxis.of(mesh, space.radius(net))), mesh)
        v, _, logs = step(v, init_darts_opt_state(v), {
            k: torch.from_numpy(a)
            for k, a in share["inputs"]["darts"].items()}, 1.0)
        out[case] = (_vars_out(v), {k: float(x) for k, x in logs.items()})
    return out


def _rank_isp(share, mesh):
    out = {}
    for arch in (FLAGSHIP, SLICE2):
        pipe = _pipeline(share, arch)
        trainer = IspTrainer(pipe, ISP_OPT, mesh=mesh)
        losses_, logits = [], []
        for batch in share["inputs"]["isp"]:
            losses_.append(trainer.train_step(batch)["loss"])
            logits.append(convert.state_to_jax(pipe)["logits"])
        out[arch] = (losses_, logits)
    return out


def _rank_yolo(share, mesh):
    blocks = ycfg.yolov3_tiny_test_blocks(num_classes=1)
    ynet = convert.yolo_weights_from_jax(share["yolo_weights"],
                                         YoloNet(blocks))
    net = _net(4)
    trainer = DartsTrainer(net, YOLO_OPT, mesh=mesh,
                           criterion=make_yolo_criterion(ynet, 32),
                           target_key="label")
    trainer._assign(convert.supernet_variables_from_jax(
        share["yolo_supernet"], net), trainer.opt_state)
    logs = trainer.search_step(*share["inputs"]["yolo"])
    return _vars_out(trainer.variables), logs


def _rank_ft(share, mesh=None):
    """DartsFtTrainer over the mesh (serial without one): 2 steps at
    K = 2, recorded, and a tuning round -> its memory and tuned proxies."""
    net = _net(4, use_proxies=True)
    trainer = DartsFtTrainer(net, FT_OPT, {"ft_steps": 2}, mesh=mesh)
    trainer._assign(convert.supernet_variables_from_jax(
        share["ft_supernet"], net), trainer.opt_state)
    for tb, vb in share["inputs"]["ft"]:
        trainer.search_step(tb, vb)
        trainer.record_intermediates(tb)
    trainer.finetune_proxies()
    return {"memory": [t.clone() for t in trainer.ft_data],
            "tuned": {s.name: [p.detach().clone() for p in
                               trainer.variables["omega"][s.name].parameters()]
                      for s in trainer.ft_ops}}


def _ranks(rank: int, root: str) -> None:
    """Every check of one rank; the results go to <root>/rank<r>.pkl."""
    with open(os.path.join(root, "share.pkl"), "rb") as f:
        share = pickle.load(f)
    mesh = meshlib.make_mesh(WORLD, space=2)
    out = {"coord": meshlib.coordinate(mesh)}
    out.update(_rank_applies(share, mesh))
    out.update(_rank_darts(share, mesh))
    out["isp"] = _rank_isp(share, mesh)
    out["yolo"] = _rank_yolo(share, mesh)
    out["ft"] = _rank_ft(share, mesh)
    with open(os.path.join(root, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


# ------------------------------------------------------- this process

def _share(inputs, root):
    """The port's seeded inits in the JAX layout, the artifact, and what
    make_serving_fn gives on its batch."""
    from reconfigisp_tpu_torch.yolo.net import init_yolo

    def supernet(seed, srgb, **kw):
        return convert.supernet_variables_to_jax(
            _net(srgb, **kw).init(torch.Generator().manual_seed(seed)))

    pipes = {arch: convert.state_to_jax(rt.Pipeline(
        arch, device="cpu", generator=torch.Generator().manual_seed(i)))
        for i, arch in enumerate(PIPES + (SERVED,))}
    blocks = ycfg.yolov3_tiny_test_blocks(num_classes=1)
    share = {
        "supernet": {4: supernet(0, 4), 7: supernet(0, 7)},
        "yolo_supernet": supernet(1, 4),
        "ft_supernet": supernet(2, 4, use_proxies=True),
        "pipes": pipes,
        "yolo_weights": convert.yolo_weights_to_jax(
            init_yolo(blocks, torch.Generator().manual_seed(7))),
        "inputs": inputs,
    }
    pipe = _pipeline(share, SERVED)
    blob = deploy.export_pipeline(pipe, inputs["serve_x"].shape,
                                  data_parallel=2, space_parallel=2)
    share["artifact"] = os.path.join(root, "space.rispt")
    deploy.save_artifact(share["artifact"], blob)
    served = deploy.make_serving_fn(pipe, device="cpu")(
        inputs["serve_x"]).numpy()
    return share, blob, served


def _jax_references(share) -> dict:
    """The JAX package on the whole batches, from the same inits."""
    import jax
    import jax.numpy as jnp

    import reconfigisp_tpu as rj
    import reconfigisp_tpu.search.trainer as jtrainer
    from reconfigisp_tpu.search.darts import (
        DartsConfig as JaxDartsConfig, init_darts_opt_state as jinit,
        make_darts_step as jstep)
    from reconfigisp_tpu.supernet import SuperNet as JaxSuperNet
    from reconfigisp_tpu.utils import losses as jlosses
    from reconfigisp_tpu.utils.checkpoint import _to_numpy
    from reconfigisp_tpu.yolo import cfg as jcfg

    from test_torch_supernet import jit_ops

    inputs = share["inputs"]
    ref = {}

    def crit(p, t, latency=None):
        return jlosses.l2(p, t)

    def forward(jnet):
        def fwd(theta, alphas, omega, img):
            return jnet({"theta": theta, "alphas": alphas, "omega": omega},
                        img), 0.0
        return fwd

    def tree(np_tree):
        return jax.tree.map(jnp.asarray, np_tree)

    batch = {k: jnp.asarray(v) for k, v in inputs["darts"].items()}
    with jax.default_matmul_precision("highest"):
        jnet4 = JaxSuperNet(1, 0.2, srgb_count=4)
        ref["apply"] = np.asarray(jax.jit(jnet4)(
            tree(share["supernet"][4]), jnp.asarray(inputs["apply_x"])))
        for arch in PIPES + (SERVED,):
            x = inputs["serve_x" if arch == SERVED else "pipe_x"]
            ref[arch] = np.asarray(jax.jit(rj.Pipeline(arch))(
                tree(share["pipes"][arch]), jnp.asarray(x)))
        for case, (order, srgb) in DARTS.items():
            # srgb 7 holds the bilateral: its JAX forms compile for minutes
            # under one jit, so that net runs eagerly with each op jitted
            jnet = (jnet4 if srgb == 4 else
                    jit_ops(JaxSuperNet(1, 0.2, srgb_count=srgb, remat=False)))
            step = jstep(forward(jnet), crit,
                         JaxDartsConfig(order=order, **CFG))
            if srgb == 4:
                step = jax.jit(step)
            v0 = tree(share["supernet"][srgb])
            v, _, logs = step(v0, jinit(v0), batch, 1.0)
            ref[case] = (_to_numpy(v), {k: float(x) for k, x in logs.items()})

        for arch in (FLAGSHIP, SLICE2):
            jt = jtrainer.IspTrainer(rj.Pipeline(arch), ISP_OPT)
            jt.state = tree(share["pipes"][arch])
            losses_, logits = [], []
            for b in inputs["isp"]:
                losses_.append(jt.train_step(b)["loss"])
                logits.append(_to_numpy(jt.state["logits"]))
            ref[f"isp {arch}"] = (losses_, logits)

        ycrit = jtrainer.make_yolo_criterion(
            jcfg.yolov3_tiny_test_blocks(num_classes=1),
            tree(share["yolo_weights"]), 32)

        def yforward(theta, alphas, omega, img):
            y, aux = jnet4({"theta": theta, "alphas": alphas,
                            "omega": omega}, img, return_aux=True)
            return y, aux["latency"]

        ystep = jax.jit(jstep(yforward, ycrit, JaxDartsConfig(
            lr_theta=1e-3, lr_alpha=1e-3, lr_meta=1e-3, order=1)))
        tb, vb = inputs["yolo"]
        yv = tree(share["yolo_supernet"])
        yv, _, ylogs = ystep(yv, jinit(yv), {
            "img": jnp.asarray(tb["noisy"]), "gt": jnp.asarray(tb["label"]),
            "val_img": jnp.asarray(vb["noisy"]),
            "val_gt": jnp.asarray(vb["label"])}, 1.0)
        ref["yolo"] = (_to_numpy(yv), {k: float(x) for k, x in ylogs.items()})
    return ref


@pytest.fixture(scope="module")
def sp(tmp_path_factory):
    root = tmp_path_factory.mktemp("space")
    share, blob, served = _share(_inputs(), str(root))
    with open(root / "share.pkl", "wb") as f:
        pickle.dump(share, f)
    failed, dryrun = [], []

    def ranks_main():
        try:
            launch.spawn(_ranks, WORLD, device="cpu",
                         init_file=str(root / "store"), args=(str(root),))
            dryrun.append(dryrun_multichip(WORLD, "cpu"))
        except Exception as err:  # noqa: BLE001 - reraised below
            failed.append(err)

    runner = threading.Thread(target=ranks_main)
    runner.start()
    try:
        ref = _jax_references(share)
        ref["ft"] = _rank_ft(share)   # the serial port trainer
    finally:
        runner.join(timeout=900)
    assert not runner.is_alive()
    if failed:
        raise failed[0]
    ranks = []
    for r in range(WORLD):
        with open(root / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return {"ranks": ranks, "ref": ref, "dryrun": dryrun[0],
            "header": deploy.split_artifact(blob)[0], "served": served,
            "start": share["supernet"]}


def _assert_vars(got, want, alpha_atol=1e-5, theta_atol=1e-5):
    for slot, a in want["alphas"].items():
        np.testing.assert_allclose(got["alphas"][slot], a, rtol=0,
                                   atol=alpha_atol, err_msg=slot)
    for slot, ops in want["theta"].items():
        for op, t in ops.items():
            np.testing.assert_allclose(got["theta"][slot][op], t, rtol=0,
                                       atol=theta_atol, err_msg=f"{slot} {op}")


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


# ------------------------------------------------------------------ tests

def test_ranks_cover_the_mesh(sp):
    coords = sorted(rank["coord"] for rank in sp["ranks"])
    assert coords == [(d, 2, s, 2) for d in range(2) for s in range(2)]


def test_supernet_apply_over_the_mesh_matches_jax(sp):
    for rank in sp["ranks"]:
        np.testing.assert_allclose(rank["apply"], sp["ref"]["apply"],
                                   atol=2e-5, rtol=0)


@pytest.mark.parametrize("arch", PIPES, ids=["flagship", "slice2", "global"])
def test_pipelines_on_windows_match_jax(sp, arch):
    """Each rank runs a window shorter than the 128-row frame; the global
    ops reduce over the space group."""
    for rank in sp["ranks"]:
        assert rank[f"{arch} window"] < 128
        np.testing.assert_allclose(rank[arch], sp["ref"][arch], atol=1e-4,
                                   rtol=0)


def test_space_artifact_served_by_four_ranks(sp):
    header = sp["header"]
    assert header["mesh"] == {"data": 2, "space": 2}
    assert header["halo"] == 2
    for rank in sp["ranks"]:
        assert rank["served"].shape == (8, 32, 32, 3)
        np.testing.assert_allclose(rank["served"], sp["served"], atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(rank["served"], sp["ref"][SERVED],
                                   atol=1e-4, rtol=0)


@pytest.mark.parametrize("case", list(DARTS))
def test_darts_step_over_the_mesh_matches_jax(sp, case):
    want_vars, want_logs = sp["ref"][case]
    for rank in sp["ranks"]:
        got_vars, got_logs = rank[case]
        for k in ("loss", "val_loss"):
            assert got_logs[k] == pytest.approx(want_logs[k], rel=1e-4), k
        _assert_vars(got_vars, want_vars)
    srgb = DARTS[case][1]
    moved = max(float(np.abs(a - sp["start"][srgb]["alphas"][s]).max())
                for s, a in want_vars["alphas"].items())
    assert moved > 1e-4


@pytest.mark.parametrize("arch", [FLAGSHIP, SLICE2],
                         ids=["flagship", "slice2"])
def test_isp_trainer_over_the_mesh_matches_jax(sp, arch):
    want_losses, want_logits = sp["ref"][f"isp {arch}"]
    for rank in sp["ranks"]:
        got_losses, got_logits = rank["isp"][arch]
        np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5)
        for got, want in zip(got_logits, want_logits):
            for name in want:
                np.testing.assert_allclose(got[name], want[name], atol=1e-5,
                                           rtol=0, err_msg=name)


def test_yolo_search_step_over_the_mesh_matches_jax(sp):
    want_vars, want_logs = sp["ref"]["yolo"]
    for rank in sp["ranks"]:
        got_vars, got_logs = rank["yolo"]
        for k in ("loss", "val_loss"):
            assert got_logs[k] == pytest.approx(want_logs[k], rel=1e-5), k
        _assert_vars(got_vars, want_vars)


def test_ft_trainer_over_the_mesh_keeps_the_serial_memory(sp):
    serial = sp["ref"]["ft"]
    for rank in sp["ranks"]:
        ft = rank["ft"]
        assert len(ft["memory"]) == len(serial["memory"]) > 0
        assert ft["memory"][0].shape == (4, 16, 16, 3)
        for a, b in zip(ft["memory"], serial["memory"]):
            assert float((a - b).abs().max()) <= 1e-6
        for name, params in serial["tuned"].items():
            for a, b in zip(ft["tuned"][name], params):
                assert float((a - b).abs().max()) <= 1e-5, name


@pytest.mark.parametrize("what", ["order2", "order1_srgb7", "isp", "yolo",
                                  "ft"])
def test_every_rank_ends_with_one_state(sp, what):
    first, *others = sp["ranks"]
    get = {"ft": lambda r: r["ft"]["tuned"]}.get(what, lambda r: r[what])
    want = _leaves(get(first))
    for rank in others:
        got = _leaves(get(rank))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            if isinstance(a, (torch.Tensor, np.ndarray)):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            else:
                assert a == b


def test_dryrun_multichip_on_four_cpu_ranks(sp):
    out = sp["dryrun"]
    assert out["mesh"] == {"data": 2, "space": 2}
    names = [line.rsplit("=", 1)[0] for line in out["lines"]]
    assert names == ["proxy_darts loss", "native_darts loss",
                     "tiled_sp max_diff", "darts_ft_k2 ft_ops=3 loss",
                     "yolo_darts loss"]
    assert len(out["launches"]) == WORLD

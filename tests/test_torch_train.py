"""Step-2 training in the port against the JAX package, on the CPU.

IspTrainer, its checkpoints both ways, the losses, metrics, schedules and
option files, and the strip backward of the three windowed ops.  Inputs come
from numpy seeds; each test states its tolerance.  The JAX trainers are
built once per case in a module fixture (each jits its step once).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import reconfigisp_tpu as rj
from reconfigisp_tpu import config as jconfig
from reconfigisp_tpu.ops import denoise as jdenoise
from reconfigisp_tpu.search.trainer import IspTrainer as JaxIspTrainer
from reconfigisp_tpu.utils import checkpoint as jcheckpoint
from reconfigisp_tpu.utils import losses as jlosses
from reconfigisp_tpu.utils import metrics as jmetrics
from reconfigisp_tpu.utils import schedule as jschedule

import reconfigisp_tpu_torch as rt
from reconfigisp_tpu_torch import config, convert
from reconfigisp_tpu_torch.ops.kernels import _vjp
from reconfigisp_tpu_torch.ops.kernels import bilateral as kb
from reconfigisp_tpu_torch.ops.kernels import fastnlm as kf
from reconfigisp_tpu_torch.ops.kernels import median as km
from reconfigisp_tpu_torch.search import IspTrainer
from reconfigisp_tpu_torch.utils import checkpoint, losses, metrics, schedule
from torch_one_thread import one_thread  # noqa: F401  (autouse)

FLAGSHIP = "Bayer_01_Demosaic_03_sRGB_01_13_11"
SLICE = "Bayer_01_Demosaic_03_sRGB_07_01_13_11"
SID_ISP = "configs/SID_isp.yaml"

# configs/SID_isp.yaml's optimiser, with a MultiStepLR milestone at step 2
TRAIN_OPT = {"lr_G": 1e-3, "beta1": 0.9, "beta2": 0.99,
             "pixel_criterion": "l2", "lr_scheme": "MultiStepLR",
             "lr_steps": [2], "lr_gamma": 0.5}
CASES = {"flagship": (FLAGSHIP, False), "slice": (SLICE, False),
         "flagship_weights": (FLAGSHIP, True)}
# Losses: the same pipeline on the same weights, its convolutions summed in
# another order (1e-4 on a pipeline's output, tests/test_torch_pipeline.py),
# through a mean square: 1e-5 relative.  Logits: Adam's step is lr times a
# ratio of moments, so a relative difference e of the gradients moves each
# logit by about lr e a step; 3 steps at lr 1e-3 stay far inside 1e-5.  (JAX
# divides by sqrt(v / bc2) + eps, torch by sqrt(v) / sqrt(bc2) + eps: equal
# up to rounding, 1e-7 of a step.)
LOSS_RTOL = 1e-5
LOGIT_ATOL = 1e-5


def _batches():
    """Three batches of 2 mosaics of 32x32 and their targets."""
    rng = np.random.default_rng(71)
    return [{"noisy": rng.uniform(0.02, 0.6, (2, 32, 32, 1)).astype(
                 np.float32),
             "gt": rng.uniform(0.05, 0.95, (2, 32, 32, 3)).astype(np.float32)}
            for _ in range(3)]


BATCHES = _batches()


def _port_logits(trainer):
    return convert.state_to_jax(trainer.pipeline)["logits"]


def _jax_logits(trainer):
    return jcheckpoint._to_numpy(trainer.state["logits"])


def _assert_logits(got: dict, want: dict, atol=LOGIT_ATOL):
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=atol,
                                   rtol=0, err_msg=name)


def _train_both(arch, train_weights, root):
    """JAX and port trainers from the same init state, 3 steps on the same
    batches, both saved after step 2."""
    jt = JaxIspTrainer(rj.Pipeline(arch), TRAIN_OPT,
                       key=jax.random.PRNGKey(0), train_weights=train_weights)
    pipe = rt.Pipeline(arch, device="cpu").load_state(
        convert.state_from_jax(jcheckpoint._to_numpy(jt.state)))
    tt = IspTrainer(pipe, TRAIN_OPT, train_weights=train_weights)
    run = {"jax": jt, "port": tt, "root": root, "jax_loss": [],
           "port_loss": [], "jax_logits": [], "port_logits": [],
           "init_logits": _port_logits(tt)}
    for i, batch in enumerate(BATCHES):
        run["jax_loss"].append(jt.train_step(batch)["loss"])
        run["port_loss"].append(tt.train_step(batch)["loss"])
        run["jax_logits"].append(_jax_logits(jt))
        run["port_logits"].append(_port_logits(tt))
        if i == 1:
            for name, trainer in (("jax", jt), ("port", tt)):
                trainer.save(str(root / name / "models"),
                             str(root / name / "state"), epoch=5)
    return run


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = _train_both(*CASES[case],
                                      tmp_path_factory.mktemp(case))
        return cache[case]

    return get


# ------------------------------------------------------------------ trainer

@pytest.mark.parametrize("case", sorted(CASES))
def test_trainer_matches_jax(runs, case):
    """Per-step losses and the logits after each of 3 steps, the schedule
    halving the lr at step 2."""
    run = runs(case)
    np.testing.assert_allclose(run["port_loss"], run["jax_loss"],
                               rtol=LOSS_RTOL)
    for got, want in zip(run["port_logits"], run["jax_logits"]):
        _assert_logits(got, want)
    moved = max(float(np.abs(v - run["init_logits"][k]).max())
                for k, v in run["port_logits"][2].items())
    assert moved > 1e-3  # the logits compared did not stand still


def test_trainer_weights_follow_jax(runs):
    """With train_weights the CNN weights are trained too: after 3 steps
    they agree with JAX's within 1e-5 (the logits' tolerance: Adam moves
    every weight by about lr a step, however small its gradient)."""
    run = runs("flagship_weights")
    want = jcheckpoint._to_numpy(run["jax"].state["weights"])
    got = convert.state_to_jax(run["port"].pipeline)["weights"]
    flat_want = jax.tree_util.tree_leaves(want)
    flat_got = jax.tree_util.tree_leaves(got)
    assert len(flat_got) == len(flat_want)
    for a, b in zip(flat_got, flat_want):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


def test_eval_loss_and_test_match_jax(runs):
    """The criterion on a batch without an update, and the output with every
    step's intermediate, after training: 1e-4, a pipeline's tolerance."""
    run = runs("slice")
    jt, tt = run["jax"], run["port"]
    batch = BATCHES[0]
    assert tt.eval_loss(batch) == pytest.approx(jt.eval_loss(batch),
                                                rel=LOSS_RTOL)
    y, mids = tt.test(batch["noisy"])
    want_y, want_mids = jt.test(batch["noisy"])
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=1e-4)
    assert list(mids) == [name for name, _ in tt.pipeline.steps]
    for got, want in zip(mids.values(), want_mids):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_trainer_passes_glb_flag():
    """With the local/global criterion the batch's glb_flag reaches it, and
    float64 arrays train as float32, as JAX takes them."""
    pipe = rt.Pipeline(FLAGSHIP, device="cpu")
    trainer = IspTrainer(pipe, dict(TRAIN_OPT,
                                    pixel_criterion="local_global_l2"))
    batch = dict(BATCHES[0], glb_flag=np.asarray([0.0, 1.0]))
    batch["gt"] = batch["gt"].astype(np.float64)
    with torch.no_grad():
        want = losses.local_global_loss(
            pipe(torch.from_numpy(batch["noisy"])),
            torch.from_numpy(BATCHES[0]["gt"]), torch.tensor([0.0, 1.0]))
    assert trainer.eval_loss(batch) == pytest.approx(float(want), rel=1e-6)
    assert np.isfinite(trainer.train_step(batch)["loss"])


# -------------------------------------------------------------- checkpoints

@pytest.mark.parametrize("case", sorted(CASES))
def test_port_checkpoint_reads_in_jax_and_resumes(runs, case):
    """The port's step-2 save: the JAX loader reads its files, they carry
    the port's state (back through state_from_jax unchanged), and the JAX
    trainer resumed from it takes step 3 as the uninterrupted JAX run
    did."""
    run = runs(case)
    jt, root = run["jax"], run["root"]
    net = jcheckpoint.load_network(str(root / "port" / "models" / "2_G.ckpt"))
    _assert_logits(net["logits"], run["port_logits"][1], atol=0)
    path = jcheckpoint.latest_state(str(root / "port" / "state"))
    st = jcheckpoint.load_training_state(path)
    assert (st["epoch"], st["step"], int(st["opt_state"]["t"])) == (5, 2, 2)
    back = rt.Pipeline(CASES[case][0], device="cpu").load_state(
        convert.state_from_jax(st["variables"]))
    again = convert.state_to_jax(back)
    _assert_logits(again["logits"], run["port_logits"][1], atol=0)
    for a, b in zip(jax.tree_util.tree_leaves(again["weights"]),
                    jax.tree_util.tree_leaves(st["variables"]["weights"])):
        np.testing.assert_array_equal(a, b)
    assert sorted(st["opt_state"]["m"]) == (
        ["logits", "weights"] if CASES[case][1] else ["logits"])
    kept = (jt.state, jt.opt_state, jt.step_idx, jt.last_logs)
    try:
        assert jt.resume(path) == 5
        assert jt.last_logs["loss"] == pytest.approx(run["port_loss"][1])
        loss = jt.train_step(BATCHES[2])["loss"]
        np.testing.assert_allclose(loss, run["jax_loss"][2], rtol=LOSS_RTOL)
        _assert_logits(_jax_logits(jt), run["jax_logits"][2])
    finally:
        jt.state, jt.opt_state, jt.step_idx, jt._last_logs = kept


@pytest.mark.parametrize("case", sorted(CASES))
def test_jax_checkpoint_resumes_in_port(runs, case):
    """The JAX trainer's step-2 save, resumed by a fresh port trainer: step
    3 gives the JAX run's loss and logits."""
    run = runs(case)
    arch, train_weights = CASES[case]
    fresh = IspTrainer(rt.Pipeline(arch, device="cpu"), TRAIN_OPT,
                       train_weights=train_weights)
    path = checkpoint.latest_state(str(run["root"] / "jax" / "state"))
    assert path.endswith("2.state")
    assert fresh.resume(path) == 5
    assert fresh.step_idx == 2
    assert fresh.last_logs["loss"] == pytest.approx(run["jax_loss"][1])
    loss = fresh.train_step(BATCHES[2])["loss"]
    np.testing.assert_allclose(loss, run["jax_loss"][2], rtol=LOSS_RTOL)
    _assert_logits(_port_logits(fresh), run["jax_logits"][2])


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_resume_continues_as_uninterrupted(runs, case):
    """Resumed from its own step-2 save, a fresh port trainer takes step 3
    bit for bit as the uninterrupted run did: the state and Adam's moments
    go through float32 numpy unchanged."""
    run = runs(case)
    arch, train_weights = CASES[case]
    fresh = IspTrainer(rt.Pipeline(arch, device="cpu"), TRAIN_OPT,
                       train_weights=train_weights)
    fresh.resume(checkpoint.latest_state(str(run["root"] / "port" / "state")))
    assert fresh.train_step(BATCHES[2])["loss"] == run["port_loss"][2]
    _assert_logits(_port_logits(fresh), run["port_logits"][2], atol=0)
    if train_weights:
        for a, b in zip(fresh.pipeline.state_dict().values(),
                        run["port"].pipeline.state_dict().values()):
            assert torch.equal(a, b)


def test_adam_state_round_trip(runs):
    """adam_state_to_jax then adam_state_from_jax gives every trained
    parameter its moments and step back; the trees hold the weights, since
    the optimizer does."""
    tt = runs("flagship_weights")["port"]
    tree = convert.adam_state_to_jax(tt.optimizer, tt.pipeline)
    assert sorted(tree["m"]) == sorted(tree["v"]) == ["logits", "weights"]
    opt = torch.optim.Adam(tt._params)
    convert.adam_state_from_jax(tree, tt.pipeline, opt)
    assert len(opt.state) == len(tt.optimizer.state)
    for p in tt._params:
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(opt.state[p][key], tt.optimizer.state[p][key])


# ------------------------------------------------------------------- losses

def _loss_case(shape=(4, 30, 22, 3)):
    rng = np.random.default_rng(72)
    pred = rng.uniform(0, 1, shape).astype(np.float32)
    target = rng.uniform(0, 1, shape).astype(np.float32)
    return pred, target


@pytest.mark.parametrize("kind", ["l1", "l2", "local_global_l2"])
def test_criterion_value_and_gradient_match_jax(kind):
    """make_criterion's losses on a batch whose size is no multiple of 4,
    local and global samples mixed: the value within 1e-5 relative (float32
    sums over 7,920 values in another order), the gradient within 1e-6 (the
    1/4-scale downsample matches jax.image.resize's antialiased bilinear at
    1.2e-7)."""
    pred, target = _loss_case()
    flag = np.asarray([0.0, 1.0, 0.5, 1.0], np.float32)
    jfn = jlosses.make_criterion(kind)
    want, want_g = jax.value_and_grad(
        lambda p: jfn(p, jnp.asarray(target), glb_flag=jnp.asarray(flag)))(
        jnp.asarray(pred))
    pt = torch.from_numpy(pred).requires_grad_()
    got = losses.make_criterion(kind)(pt, torch.from_numpy(target),
                                      glb_flag=torch.from_numpy(flag))
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(want_g),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("flag", [[0, 0, 0, 0], [1, 1, 1, 1]])
def test_local_global_loss_one_kind_only(flag):
    pred, target = _loss_case((4, 16, 16, 3))
    flag = np.asarray(flag, np.float32)
    want = jlosses.local_global_loss(jnp.asarray(pred), jnp.asarray(target),
                                     jnp.asarray(flag))
    got = losses.local_global_loss(torch.from_numpy(pred),
                                   torch.from_numpy(target),
                                   torch.from_numpy(flag))
    assert float(got) == pytest.approx(float(want), rel=1e-5)


def test_latency_loss():
    """With a latency the value is JAX's; without one (an op with no entry
    in the port's latency table) the criterion says so."""
    pred, target = _loss_case((2, 8, 8, 3))
    opt = {"w": 0.5, "target_latency": 2.0}
    want = jlosses.make_criterion("l2_latency", opt)(
        jnp.asarray(pred), jnp.asarray(target), latency=3.0)
    fn = losses.make_criterion("l2_latency", opt)
    got = fn(torch.from_numpy(pred), torch.from_numpy(target), latency=3.0)
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    with pytest.raises(ValueError, match="latency"):
        fn(torch.from_numpy(pred), torch.from_numpy(target), latency=None)
    with pytest.raises(ValueError, match="unknown"):
        losses.make_criterion("l3")


# ------------------------------------------------------------------ metrics

def test_psnr_and_ssim_match_jax():
    """Per image, 1e-5 (SSIM's window sums are f32 convolutions in another
    order)."""
    rng = np.random.default_rng(73)
    x = rng.uniform(0, 1, (3, 24, 20, 3)).astype(np.float32)
    y = np.clip(x + 0.05 * rng.standard_normal(x.shape), 0, 1).astype(
        np.float32)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    np.testing.assert_allclose(metrics.psnr(tx, ty).numpy(),
                               np.asarray(jmetrics.psnr(x, y)), rtol=1e-6)
    np.testing.assert_allclose(metrics.ssim(tx, ty).numpy(),
                               np.asarray(jmetrics.ssim(x, y)), atol=1e-5)
    np.testing.assert_allclose(metrics.mse(tx, ty).numpy(),
                               np.asarray(jmetrics.mse(x, y)), rtol=1e-6)
    assert metrics.ssim(tx, tx).numpy() == pytest.approx(1.0, abs=1e-5)


# ---------------------------------------------------------------- schedules

@pytest.mark.parametrize("opt", [
    {"lr_steps": [3, 6], "lr_gamma": 0.5},
    {"lr_steps": [2, 4, 8], "lr_gamma": 0.1, "restarts": [5],
     "restart_weights": [0.5]},
    {"lr_steps": [4], "warmup_iter": 3},
    {"lr_scheme": "CosineAnnealingLR_Restart", "lr_G": 1e-3,
     "eta_min": 1e-5, "T_period": [4, 6], "restarts": [4],
     "restart_weights": [0.8]},
    {"lr_scheme": "CosineAnnealingLR_Restart", "lr_G": 1e-3, "niter": 7,
     "warmup_iter": 2},
], ids=["multistep", "multistep_restart", "warmup", "cosine_restart",
        "cosine_niter_warmup"])
def test_schedule_matches_jax(opt):
    """Steps 0-12 around the milestones, restarts and warm-up: the same
    Python arithmetic, so equal."""
    got, want = schedule.make_schedule(opt), jschedule.make_schedule(opt)
    assert [got(s) for s in range(13)] == [want(s) for s in range(13)]


def test_unknown_schedule_raises():
    with pytest.raises(NotImplementedError):
        schedule.make_schedule({"lr_scheme": "StepLR"})


# -------------------------------------------------------------- option files

@pytest.mark.parametrize("name", ["SID_isp", "SID_isp_debug"])
def test_config_parse_matches_jax(tmp_path, name):
    """configs/SID_isp.yaml under a root, as run and as a debug run; the
    default bank is installed where the root holds one."""
    (tmp_path / "experiments" / "proxies").mkdir(parents=True)
    (tmp_path / "experiments" / "proxies" / "default.ckpt").write_bytes(b"")
    with open(SID_ISP) as f:
        text = f.read().replace("name: SID_isp", f"name: {name}")
    path = tmp_path / "opt.yaml"
    path.write_text(text)
    for is_train in (True, False):
        got = config.parse(str(path), is_train, root=str(tmp_path))
        want = jconfig.parse(str(path), is_train, root=str(tmp_path))
        assert got == want
        assert got["no_such_key"] is None
        assert got["train"]["no_such_key"] is None
        assert config.dict2str(got) == jconfig.dict2str(want)
    assert got["network_G"]["architecture"] == FLAGSHIP


@pytest.mark.parametrize("net_opt,expected", [
    ({"which_model_G": "IspUniversal"}, True),
    ({"which_model_G": "OriginUniversal"}, False),
    ({"which_model_G": "IspUniversal", "use_proxy": False}, False),
    ({"which_model_G": "Pipeline", "use_proxy": True}, True),
])
def test_network_uses_proxy(net_opt, expected):
    assert config.network_uses_proxy(net_opt) is expected
    assert jconfig.network_uses_proxy(net_opt) is expected


def test_latest_state_orders_by_iteration(tmp_path):
    for it in (2, 10, 9):
        checkpoint.save_training_state(str(tmp_path), it, epoch=0, step=it,
                                       variables={}, opt_state={})
    assert checkpoint.latest_state(str(tmp_path)).endswith("10.state")
    assert checkpoint.latest_state(str(tmp_path / "none")) is None


# ------------------------------------------------------------ strip backward

# name -> (plain form, its JAX form, halo, params rows).  The JAX forms are
# the ones the JAX package runs at this size: the median at the radius the
# params select (_median_jnp's branch for 7, which spares compiling the six
# others) and fast-NLM's one-pass _fastnlm_vec, whose numerics are
# _fastnlm_jnp's and which compiles in seconds, where the rolled form takes
# most of a minute.
_STRIP_OPS = {
    "bilateral": (kb.bilateral_plain, jdenoise._bilateral_jnp, kb.HALO,
                  [[0.99, 0.2, 0.3], [0.45, 0.05, 0.8]]),
    "median": (km.median_plain,
               lambda v, q: jnp.clip(jdenoise._median_fixed(v, 7), 0.0, 1.0),
               km.HALO, [[0.99], [0.99]]),
    "fastnlm": (kf.fastnlm_plain, jdenoise._fastnlm_vec, kf.HALO,
                [[0.99, 0.99, 0.3], [0.0, 0.45, 0.1]]),
}


@pytest.mark.parametrize("name", sorted(_STRIP_OPS))
def test_strip_vjp_matches_direct_and_jax(name):
    """At radius 7 (fast-NLM: block and search 7) on 64 rows in strips of 16
    (4 chunks, two at the frame's edges).  The input gradient: within 1e-5
    of the direct autograd (the same arithmetic, summed by slabs), and of
    JAX's _strip_vjp within 1e-5 plus 1e-5 relative (the plain forms'
    gradients part from JAX's by 1.2e-5 at values near 3, strip or not).
    The params' gradient, a sum over the frame in another order, within 1e-5
    of its size."""
    plain, jnp_fn, halo, rows = _STRIP_OPS[name]
    rng = np.random.default_rng(74)
    x = rng.uniform(0, 1, (2, 64, 20, 3)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    p = np.asarray(rows, np.float32)
    args = (torch.from_numpy(x), torch.from_numpy(p), torch.from_numpy(g))
    gx, gp = _vjp.strip_vjp(plain, halo, *args, strip=16)
    dx, dp = _vjp._grads(plain, *args, needs=(True, True))
    jx, jp = jdenoise._strip_vjp(jnp_fn, halo, jnp.asarray(x),
                                 jnp.asarray(p), jnp.asarray(g), strip=16)
    np.testing.assert_allclose(gx.numpy(), dx.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(gx.numpy(), np.asarray(jx), atol=1e-5,
                               rtol=1e-5)
    if name == "median":  # its params set only the radius
        assert gp is None and dp is None
        assert not np.asarray(jp).any()
        return
    for want in (dp.numpy(), np.asarray(jp)):
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(gp.numpy(), want, atol=1e-5 * scale,
                                   rtol=0)


def test_vjp_goes_by_strips_above_the_direct_rows(monkeypatch):
    """vjp, what the kernels' backward returns, is the direct gradient up to
    DIRECT_ROWS rows and strip_vjp's above; an input that needs no gradient
    gets None."""
    rng = np.random.default_rng(75)
    x = torch.from_numpy(rng.uniform(0, 1, (1, 48, 16, 3)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    p = torch.tensor([[0.5, 0.3, 0.2]])
    direct = _vjp.vjp(kb.bilateral_plain, kb.HALO, x, p, g)
    assert all(torch.equal(a, b) for a, b in zip(
        direct, _vjp._grads(kb.bilateral_plain, x, p, g, (True, True))))
    monkeypatch.setattr(_vjp, "DIRECT_ROWS", 16)
    monkeypatch.setattr(_vjp, "STRIP", 8)
    strips = _vjp.vjp(kb.bilateral_plain, kb.HALO, x, p, g)
    want = _vjp.strip_vjp(kb.bilateral_plain, kb.HALO, x, p, g, strip=8)
    assert all(torch.equal(a, b) for a, b in zip(strips, want))
    torch.testing.assert_close(strips[0], direct[0], atol=1e-5, rtol=0)
    gx, gp = _vjp.vjp(kb.bilateral_plain, kb.HALO, x, p, g, (False, True))
    assert gx is None and gp.shape == p.shape

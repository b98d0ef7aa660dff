"""The port's DARTS step, DartsTrainer and latency calibration against the
JAX package, on the CPU.

Both sides start from the JAX init, carried into the port through
convert.supernet_variables_from_jax, and take the same numpy batches
(batch 2 of 32x32 mosaics, n_step 1).  The JAX step runs eagerly with each
op jitted (as in tests/test_torch_supernet.py), except inside the JAX
DartsTrainer, which jits its own step; JAX matmuls and convolutions run at
"highest" precision.

Tolerances.  The forward passes agree within 1e-4 and the gradients within
1e-3 of their largest component (tests/test_torch_supernet.py).  Adam moves
an alpha by lr m_hat / (sqrt(v_hat) + eps), a ratio that a relative change
e of the gradient moves by about e, so after 3 steps at lr 1e-2 with
e <= 1e-3 the alphas agree within ALPHA_ATOL = 3e-5.  SGD moves a logit by
lr buf, buf a sum of gradients of order 0.1-1: theta within THETA_ATOL =
1e-5.  Losses within 1e-5 relative (the forward's 1e-4 through a mean
square).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reconfigisp_tpu import registry as jregistry
from reconfigisp_tpu.search.darts import (
    DartsConfig as JaxDartsConfig, init_darts_opt_state as jax_init_opt,
    make_darts_step as jax_make_step)
from reconfigisp_tpu.search.trainer import DartsTrainer as JaxDartsTrainer
from reconfigisp_tpu.supernet import SuperNet as JaxSuperNet
from reconfigisp_tpu.utils import latency as jlatency
from reconfigisp_tpu.utils import losses as jlosses
from reconfigisp_tpu.utils.checkpoint import _to_numpy

from reconfigisp_tpu_torch import config, convert, registry
from reconfigisp_tpu_torch.search import DartsTrainer
from reconfigisp_tpu_torch.search.darts import (
    DartsConfig, init_darts_opt_state, make_darts_step)
from reconfigisp_tpu_torch.supernet import SuperNet
from reconfigisp_tpu_torch.utils import latency, losses
from reconfigisp_tpu_torch.utils.checkpoint import load_network

from test_torch_supernet import jit_ops
from torch_one_thread import one_thread  # noqa: F401  (autouse)

BANK = "experiments/proxies/default.ckpt"
ALPHA_ATOL = 3e-5
THETA_ATOL = 1e-5
LOSS_RTOL = 1e-5
LR_SCALES = (1.0, 0.5, 0.25)   # a schedule's scale, changing every step
CFG = dict(lr_theta=1e-2, lr_alpha=1e-2, lr_meta=1e-2, momentum=0.9)
# configs/planted_search.yaml's optimiser, with a MultiStepLR milestone at
# step 2 so the lr changes within the run
TRAIN_OPT = {"lr_G": 1e-2, "momentum_G": 0.9, "lr_meta": 1e-2, "beta1": 0.9,
             "beta2": 0.99, "pixel_criterion": "l2",
             "lr_scheme": "MultiStepLR", "lr_steps": [2], "lr_gamma": 0.5}


def _batch(seed, key_names=("img", "gt", "val_img", "val_gt")):
    rng = np.random.default_rng(seed)
    out = {}
    for k in key_names:
        c = 1 if "img" in k or k == "noisy" else 3
        out[k] = rng.uniform(0.05, 0.95, (2, 32, 32, c)).astype(np.float32)
    return out


BATCHES = [_batch(10 + i) for i in range(3)]


def _forwards(jnet, net, theta_frozen=False, nan_slot=None):
    """The JAX and port forwards of make_darts_step.  `theta_frozen` stops
    theta's gradient (so dtheta_v = 0 and eps = 0); `nan_slot` adds
    0 sqrt(a - a) of that slot's alphas, whose gradient is 0 inf = NaN."""
    def jfwd(theta, alphas, omega, img):
        if theta_frozen:
            theta = jax.lax.stop_gradient(theta)
        y, aux = jnet({"theta": theta, "alphas": alphas, "omega": omega},
                      img, return_aux=True)
        if nan_slot:
            a = alphas[nan_slot]
            y = y + 0.0 * jnp.sum(jnp.sqrt(a - jax.lax.stop_gradient(a)))
        return y, aux["latency"]

    def fwd(theta, alphas, omega, img):
        if theta_frozen:
            theta = {s: {k: t.detach() for k, t in d.items()}
                     for s, d in theta.items()}
        y, aux = net({"theta": theta, "alphas": alphas, "omega": omega},
                     img, return_aux=True)
        if nan_slot:
            a = alphas[nan_slot]
            y = y + 0.0 * torch.sum(torch.sqrt(a - a.detach()))
        return y, aux["latency"]

    return jfwd, fwd


def _assert_vars(port_vars, jax_vars, alpha_atol=ALPHA_ATOL,
                 theta_atol=THETA_ATOL):
    got = convert.supernet_variables_to_jax(port_vars)
    want = _to_numpy(jax_vars)
    for slot, a in want["alphas"].items():
        np.testing.assert_allclose(got["alphas"][slot], a, rtol=0,
                                   atol=alpha_atol, err_msg=slot)
    for slot, ops in want["theta"].items():
        for op, t in ops.items():
            np.testing.assert_allclose(got["theta"][slot][op], t, rtol=0,
                                       atol=theta_atol, err_msg=f"{slot} {op}")


def _run_steps(srgb_count, order, *, criterion="l2", steps=3, **fwd_kw):
    """3 steps of both steps from the JAX init -> per-step logs and
    variables of each."""
    jnet = jit_ops(JaxSuperNet(1, 0.2, srgb_count=srgb_count, remat=False))
    np_vars = _to_numpy(jnet.init(jax.random.PRNGKey(0)))
    net = SuperNet(1, 0.2, srgb_count=srgb_count, device="cpu")
    jfwd, fwd = _forwards(jnet, net, **fwd_kw)
    opt = {"w": 1.0, "target_latency": 1.0}
    jstep = jax_make_step(jfwd, jlosses.make_criterion(criterion, opt),
                          JaxDartsConfig(order=order, **CFG))
    step = make_darts_step(fwd, losses.make_criterion(criterion, opt),
                           DartsConfig(order=order, **CFG))
    jv = jax.tree.map(jnp.asarray, np_vars)
    jo = jax_init_opt(jv)
    v = convert.supernet_variables_from_jax(np_vars, net)
    o = init_darts_opt_state(v)
    out = {"jax": [], "port": [], "start": np_vars}
    for i in range(steps):
        b = BATCHES[i]
        with jax.default_matmul_precision("highest"):
            jv, jo, jlogs = jstep(jv, jo, {k: jnp.asarray(a) for k, a in
                                           b.items()}, LR_SCALES[i])
        v, o, logs = step(v, o, {k: torch.from_numpy(a) for k, a in
                                 b.items()}, LR_SCALES[i])
        out["jax"].append((jv, jo, {k: float(x) for k, x in jlogs.items()}))
        out["port"].append((v, o, {k: float(x) for k, x in logs.items()}))
    return out


def _assert_steps_match(run):
    for (v, o, logs), (jv, jo, jlogs) in zip(run["port"], run["jax"]):
        for k in ("loss", "val_loss"):
            assert logs[k] == pytest.approx(jlogs[k], rel=LOSS_RTOL), k
        assert logs["eps"] == pytest.approx(jlogs["eps"], rel=1e-3, abs=1e-12)
        _assert_vars(v, jv)
        back = convert.darts_opt_state_to_jax(o)
        assert int(back["adam_t"]) == int(jo["adam_t"])
        for slot, m in _to_numpy(jo["momentum"]).items():
            for op, buf in m.items():
                np.testing.assert_allclose(
                    back["momentum"][slot][op], buf, rtol=0,
                    atol=1e-3 * max(1e-6, float(np.abs(buf).max())))


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(case):
        if case not in cache:
            srgb_count, order = case
            cache[case] = _run_steps(srgb_count, order)
        return cache[case]

    return get


# ------------------------------------------------------------------- steps

@pytest.mark.parametrize("case", [(6, 2), (6, 1), (9, 2)],
                         ids=["order2_srgb6", "order1_srgb6",
                              "order2_srgb9_windowed"])
def test_step_matches_jax(runs, case):
    """3 steps with lr scales 1, 0.5, 0.25: losses, eps, alphas, theta and
    the optimiser state.  srgb 9 passes through bilateral, median and
    fast-NLM, so the Hessian probes difference their gradients."""
    run = runs(case)
    _assert_steps_match(run)
    v, _, logs = run["port"][-1]
    moved = max(float(np.abs(a.numpy() - run["start"]["alphas"][s]).max())
                for s, a in v["alphas"].items())
    assert moved > 1e-3
    if case[1] == 1:
        assert all(p[2]["eps"] == 0.0 for p in run["port"])
    else:
        assert all(p[2]["eps"] > 0.0 for p in run["port"])


def test_eps_zero_branch_matches_jax():
    """A validation loss that does not reach theta: dtheta_v = 0, so eps = 0
    and the Hessian term is 0; the step is JAX's."""
    run = _run_steps(6, 2, steps=2, theta_frozen=True)
    _assert_steps_match(run)
    assert all(p[2]["eps"] == 0.0 and p[2]["dtheta_norm"] == 0.0
               for p in run["port"])


def test_nan_guard_zeroes_the_slot_as_jax():
    """A NaN in the bayer slot's alpha gradient zeroes that slot's step
    (the reference's guard, darts_model.py:260-263); the other slots move."""
    run = _run_steps(6, 2, steps=2, nan_slot="bayer")
    _assert_steps_match(run)
    v = run["port"][-1][0]
    start = run["start"]["alphas"]
    np.testing.assert_array_equal(v["alphas"]["bayer"].numpy(),
                                  start["bayer"])
    assert np.abs(v["alphas"]["step1"].numpy() - start["step1"]).max() > 0


def test_lr_scale_zero_freezes_the_variables():
    """lr_scale 0: alphas and theta stay bit for bit; the optimiser state
    still moves, as JAX's does."""
    net = SuperNet(1, 0.2, srgb_count=6, device="cpu")
    v = net.init()
    o = init_darts_opt_state(v)

    def fwd(theta, alphas, omega, img):
        y, aux = net({"theta": theta, "alphas": alphas, "omega": omega},
                     img, return_aux=True)
        return y, aux["latency"]

    step = make_darts_step(fwd, losses.make_criterion("l2"),
                           DartsConfig(**CFG))
    b = {k: torch.from_numpy(a) for k, a in BATCHES[0].items()}
    nv, no, _ = step(v, o, b, 0.0)
    for slot in v["alphas"]:
        assert torch.equal(nv["alphas"][slot], v["alphas"][slot])
        for op in v["theta"][slot]:
            assert torch.equal(nv["theta"][slot][op], v["theta"][slot][op])
    assert int(no["adam_t"]) == 1
    assert any(bool(t.abs().max() > 0) for d in no["momentum"].values()
               for t in d.values())


@pytest.fixture
def made_up_latency():
    """One made-up table in both registries, both restored afterwards."""
    table = {name: 0.5 + 0.37 * i
             for i, name in enumerate(registry.LATENCY_MS_PER_MP)}
    port_before = dict(registry.LATENCY_MS_PER_MP)
    jax_before = {d: dict(jregistry.registry[d]) for d in jregistry.registry}
    latency.install(table)
    jlatency.install(table)
    yield table
    registry.LATENCY_MS_PER_MP.update(port_before)
    for d, entries in jax_before.items():
        jregistry.registry[d].clear()
        jregistry.registry[d].update(entries)


def test_l2_latency_step_matches_jax(made_up_latency):
    """The latency-aware criterion: fidelity times (latency / target)^w,
    with the supernet's expected latency under a made-up table."""
    run = _run_steps(6, 2, criterion="l2_latency", steps=2)
    _assert_steps_match(run)


def test_l2_latency_raises_without_a_table():
    """With the registry's table unmeasured (None) the criterion says so."""
    before = dict(registry.LATENCY_MS_PER_MP)
    registry.LATENCY_MS_PER_MP["gamma"] = None
    try:
        trainer = DartsTrainer(
            SuperNet(1, 0.2, srgb_count=6, device="cpu"),
            dict(TRAIN_OPT, pixel_criterion="l2_latency"))
        b = _batch(20, ("noisy", "gt"))
        with pytest.raises(ValueError, match="latency"):
            trainer.search_step(b, b)
    finally:
        registry.LATENCY_MS_PER_MP.update(before)


# ----------------------------------------------------------------- trainer

def _trainer_batches():
    return [(_batch(30 + i, ("noisy", "gt")), _batch(40 + i, ("noisy", "gt")))
            for i in range(3)]


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    """The JAX and port DartsTrainer from the JAX init, with the in-repo
    bank loaded in both, 2 steps, both saved, then a third step."""
    root = tmp_path_factory.mktemp("darts")
    bank = load_network(BANK)
    jt = JaxDartsTrainer(JaxSuperNet(1, 0.2, srgb_count=6), TRAIN_OPT,
                         key=jax.random.PRNGKey(0))
    net = SuperNet(1, 0.2, srgb_count=6, device="cpu")
    pt = DartsTrainer(net, TRAIN_OPT)
    pt.variables = convert.supernet_variables_from_jax(
        _to_numpy(jt.variables), net)
    out = {"jax": jt, "port": pt, "root": root, "net": net,
           "installed": (sorted(jt.load_pretrained(bank)),
                         sorted(pt.load_pretrained(bank))),
           "jax_logs": [], "port_logs": [], "jax_vars": [], "port_vars": []}
    out["jax_start"] = (jt.variables, jt.opt_state)   # immutable arrays
    for i, (tb, vb) in enumerate(_trainer_batches()):
        with jax.default_matmul_precision("highest"):
            out["jax_logs"].append(jt.search_step(tb, vb))
        out["port_logs"].append(pt.search_step(tb, vb))
        out["jax_vars"].append(_to_numpy(jt.variables))
        out["port_vars"].append(convert.supernet_variables_to_jax(
            pt.variables))
        if i == 1:
            for name, t in (("jax", jt), ("port", pt)):
                t.save(str(root / name / "models"), str(root / name / "state"),
                       epoch=3)
    return out


def test_trainer_matches_jax(trainers):
    """Both install the bank's path_bayer and demosaicnet, then search 3
    steps with the schedule's milestone at step 2."""
    assert trainers["installed"][0] == trainers["installed"][1] == [
        "demosaicnet", "path_bayer"]
    for logs, jlogs in zip(trainers["port_logs"], trainers["jax_logs"]):
        assert logs["loss"] == pytest.approx(jlogs["loss"], rel=LOSS_RTOL)
        assert logs["val_loss"] == pytest.approx(jlogs["val_loss"],
                                                 rel=LOSS_RTOL)
    for got, want in zip(trainers["port_vars"], trainers["jax_vars"]):
        _assert_vars({"alphas": {k: torch.from_numpy(a) for k, a in
                                 got["alphas"].items()},
                      "theta": {s: {k: torch.from_numpy(a) for k, a in
                                    d.items()} for s, d in
                                got["theta"].items()},
                      "omega": {}}, want)
    assert trainers["port"].last_logs == trainers["port_logs"][-1]
    assert trainers["port"].architecture() == trainers["jax"].architecture()


def test_k_step_dispatch_matches_the_jax_single_step_trainer(trainers):
    """A port trainer with steps_per_dispatch 4 fed 5 steps, then flushed,
    against the JAX trainer's own jitted single steps on the same stream
    from the same start (its state put back afterwards): steps 1-3 return
    the initial logs, step 4 dispatches and returns its own, step 5 is
    buffered until the flush; the losses, the final variables and the
    decoded architecture are JAX's at the tolerances above."""
    jt = trainers["jax"]
    saved = (jt.variables, jt.opt_state, jt.step_idx, jt._last_logs)
    pairs = [(_batch(60 + i, ("noisy", "gt")), _batch(65 + i, ("noisy", "gt")))
             for i in range(5)]
    jt.variables, jt.opt_state = trainers["jax_start"]
    jt.step_idx = 0
    try:
        with jax.default_matmul_precision("highest"):
            jlogs = [jt.search_step(tb, vb) for tb, vb in pairs]
        jvars = _to_numpy(jt.variables)
        jarch = jt.architecture()
    finally:
        jt.variables, jt.opt_state, jt.step_idx, jt._last_logs = saved

    net = trainers["net"]
    pt = DartsTrainer(net, dict(TRAIN_OPT, steps_per_dispatch=4))
    pt.variables = convert.supernet_variables_from_jax(
        _to_numpy(trainers["jax_start"][0]), net)
    logs = [pt.search_step(tb, vb) for tb, vb in pairs]
    assert all(np.isnan(lg["loss"]) for lg in logs[:3])
    assert logs[4] == logs[3] and len(pt._buf) == 1
    for k in ("loss", "val_loss"):
        assert logs[3][k] == pytest.approx(jlogs[3][k], rel=LOSS_RTOL), k
    pt.flush()
    assert pt.step_idx == 5 and not pt._buf
    for k in ("loss", "val_loss"):
        assert pt.last_logs[k] == pytest.approx(jlogs[4][k], rel=LOSS_RTOL)
    _assert_vars(pt.variables, jvars)
    assert pt.architecture() == jarch


def test_pruned_paths_match_jax(trainers):
    img = _batch(50, ("noisy",))["noisy"]
    with jax.default_matmul_precision("highest"):
        want = trainers["jax"].pruned_paths(img)
    np.testing.assert_array_equal(trainers["port"].pruned_paths(img), want)


def _resumed_port(trainers, state):
    t = DartsTrainer(trainers["net"], TRAIN_OPT)
    assert t.resume(state) == 3
    return t


def test_jax_checkpoint_resumes_in_port(trainers):
    """The JAX trainer's step-2 state -> the port, one step -> the JAX
    trainer's step 3."""
    state = str(trainers["root"] / "jax" / "state" / "2.state")
    t = _resumed_port(trainers, state)
    assert t.step_idx == 2
    assert t.last_logs == pytest.approx(trainers["jax_logs"][1])
    tb, vb = _trainer_batches()[2]
    t.search_step(tb, vb)
    want = trainers["jax_vars"][2]
    _assert_vars(t.variables, {k: want[k] for k in ("alphas", "theta")})


def test_port_checkpoint_resumes_in_jax(trainers):
    """The port's step-2 network and state read in the JAX package: the
    network file's variables, and the JAX trainer resumed from the state
    (its own jitted step, so nothing compiles again), whose step 3 is the
    port's."""
    root = trainers["root"] / "port"
    net_file = load_network(str(root / "models" / "2_G.ckpt"))
    assert sorted(net_file) == ["alphas", "omega", "theta"]
    jt = trainers["jax"]   # no later test reads its variables
    assert jt.resume(str(root / "state" / "2.state")) == 3
    tb, vb = _trainer_batches()[2]
    with jax.default_matmul_precision("highest"):
        jt.search_step(tb, vb)
    want = trainers["port_vars"][2]
    port_vars = {"alphas": {k: torch.from_numpy(a) for k, a in
                            want["alphas"].items()},
                 "theta": {s: {k: torch.from_numpy(a) for k, a in d.items()}
                           for s, d in want["theta"].items()}, "omega": {}}
    _assert_vars(port_vars, {k: jt.variables[k] for k in ("alphas", "theta")})


def test_port_resume_continues_as_uninterrupted(trainers):
    """Resumed from its own step-2 state, the port's step 3 is the
    uninterrupted run's, bit for bit."""
    t = _resumed_port(trainers, str(trainers["root"] / "port" / "state"
                                    / "2.state"))
    tb, vb = _trainer_batches()[2]
    logs = t.search_step(tb, vb)
    assert logs == trainers["port_logs"][2]
    got = convert.supernet_variables_to_jax(t.variables)
    want = trainers["port_vars"][2]
    for slot in want["alphas"]:
        np.testing.assert_array_equal(got["alphas"][slot],
                                      want["alphas"][slot])


def test_darts_state_round_trip(trainers):
    o = trainers["port"].opt_state
    back = convert.darts_opt_state_from_jax(
        convert.darts_opt_state_to_jax(o), "cpu")
    assert int(back["adam_t"]) == int(o["adam_t"]) == 3
    for slot in o["adam_m"]:
        assert torch.equal(back["adam_m"][slot], o["adam_m"][slot])
        assert torch.equal(back["adam_v"][slot], o["adam_v"][slot])
    for slot, d in o["momentum"].items():
        for op, buf in d.items():
            assert torch.equal(back["momentum"][slot][op], buf)


@pytest.mark.parametrize("model,net_opt,expected", [
    ("darts", {"n_step": 3, "n_modules": 15, "prune_threshold": 0.2,
               "use_proxies": False},
     {"n_step": 3, "threshold": 0.2, "use_proxies": False, "srgb_count": 15,
      "remat": True}),
    ("darts_ft", {"n_step": 2, "srgb_count": 9, "remat": False},
     {"n_step": 2, "threshold": 0.2, "use_proxies": True, "srgb_count": 9,
      "remat": False}),
    ("darts", {}, {"n_step": 3, "threshold": 0.2, "use_proxies": False,
                   "srgb_count": 15, "remat": True}),
])
def test_supernet_kwargs_as_run_training_reads_them(model, net_opt, expected):
    opt = config.dict_to_nonedict({"model": model, "network_G": net_opt})
    assert config.supernet_kwargs(opt) == expected


# ----------------------------------------------------------------- latency

def test_calibrate_on_the_cpu_then_install():
    """A few ops timed on the CPU: a positive, finite ms/MP each; install
    writes them into the registry, which the supernet's latency then
    reads."""
    before = dict(registry.LATENCY_MS_PER_MP)
    try:
        table = latency.calibrate(size=32, batch=1,
                                  ops={"gamma", "median", "bilateral",
                                       "laplacian", "bm3d"}, device="cpu")
        assert sorted(table) == ["bilateral", "bm3d", "gamma", "laplacian",
                                 "median"]
        assert all(np.isfinite(v) and v > 0 for v in table.values())
        latency.install(table)
        assert registry.LATENCY_MS_PER_MP["median"] == table["median"]
        with pytest.raises(KeyError):
            latency.install({"no_such_op": 1.0})
    finally:
        registry.LATENCY_MS_PER_MP.update(before)

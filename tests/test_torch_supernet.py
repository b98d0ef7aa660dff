"""The port's SuperNet against the JAX package's, on the CPU.

The JAX variables are drawn once and carried into the port through
convert.supernet_variables_from_jax, so both nets hold the same alphas,
logits and weights.  Inputs are numpy draws: batch 2 of 32x32 mosaics,
n_step 1.  The JAX supernet runs eagerly with each op jitted (`jit_ops`,
one compile per op and shape): a jit of the whole net with its windowed
ops compiles for minutes on the CPU, and jit computes the same function.  JAX
matmuls and convolutions run at "highest" precision (this JAX build
defaults to bf16 on the CPU).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reconfigisp_tpu import registry as jregistry
from reconfigisp_tpu.supernet import SuperNet as JaxSuperNet
from reconfigisp_tpu.utils import latency as jlatency
from reconfigisp_tpu.utils.checkpoint import _to_numpy

from reconfigisp_tpu_torch import convert, registry
from reconfigisp_tpu_torch.supernet import SuperNet
from reconfigisp_tpu_torch.utils import latency

# case -> (srgb_count, use_proxies).  15 holds the windowed ops 7-9 and
# path_bgr natively; with proxies, 2-4 and 6-9 and bm3d run as one bank.
CASES = {"srgb6": (6, False), "srgb15": (15, False),
         "srgb15_proxies": (15, True)}
# Forward: the same ops on the same weights, convolutions summed in another
# order (1e-4 through Path-Restore, tests/test_torch_pipeline.py) and the
# windowed ops' plain forms within 2e-5 of the jnp forms: 1e-4.
FWD_ATOL = 1e-4
# Gradients: those differences through the backward of a mean square over
# 6,144 outputs; 1e-3 of the largest component of each gradient (the
# alphas', theta's and the input's are of different sizes).
GRAD_RTOL = 1e-3


def _jitted(apply):
    """apply(x, params, weights) for an op without weights, as a jitted
    forward whose gradient is one jitted jax.vjp for x and params: the same
    function and gradient, compiled once per shape, where JAX would
    linearise a jitted op anew for each set of inputs a pass differentiates
    (the JAX package's own hybrid ops take their backward the same way,
    reconfigisp_tpu/ops/denoise.py:_make_hybrid)."""
    fwd = jax.jit(lambda x, p: apply(x, p, None))
    vjp = jax.jit(lambda x, p, g: jax.vjp(
        lambda a, b: apply(a, b, None), x, p)[1](g))

    @jax.custom_vjp
    def op(x, p):
        return fwd(x, p)

    op.defvjp(lambda x, p: (fwd(x, p), (x, p)),
              lambda res, g: vjp(*res, g))
    return lambda x, p, w: op(x, p)


def jit_ops(net):
    """Each op of each slot jitted: an op with weights as it is, one
    without through _jitted."""
    def jitted(spec):
        kw = {k: jax.jit(getattr(spec, k)) for k in ("apply", "proxy_apply")
              if getattr(spec, k) is not None}
        if spec.apply is not None and spec.init_weights is None:
            kw["apply"] = _jitted(spec.apply)
        return dataclasses.replace(spec, **kw)
    net.slots = [(slot, [jitted(s) for s in ops]) for slot, ops in net.slots]
    return net


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.05, 0.95, (2, 32, 32, 1)).astype(np.float32),
            rng.uniform(0.05, 0.95, (2, 32, 32, 3)).astype(np.float32))


def _nets(srgb_count, use_proxies, **kw):
    """(JAX net, its numpy variables, port net, port variables)."""
    jnet = jit_ops(JaxSuperNet(1, 0.2, use_proxies=use_proxies,
                               srgb_count=srgb_count, **kw))
    np_vars = _to_numpy(jnet.init(jax.random.PRNGKey(0)))
    net = SuperNet(1, 0.2, use_proxies=use_proxies, srgb_count=srgb_count,
                   device="cpu", **kw)
    return jnet, np_vars, net, convert.supernet_variables_from_jax(np_vars, net)


def _jax_run(jnet, np_vars, x, gt, **kw):
    """JAX forward and the gradients of the mean square error with respect
    to the alphas, theta and the input."""
    omega = jax.tree.map(jnp.asarray, np_vars["omega"])

    def loss(alphas, theta, x_):
        y, aux = jnet({"alphas": alphas, "theta": theta, "omega": omega},
                      x_, return_aux=True, **kw)
        return jnp.mean((y - gt) ** 2), (y, aux)

    with jax.default_matmul_precision("highest"):
        (val, (y, aux)), grads = jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True)(
            jax.tree.map(jnp.asarray, np_vars["alphas"]),
            jax.tree.map(jnp.asarray, np_vars["theta"]), jnp.asarray(x))
    return {"loss": float(val), "y": np.asarray(y),
            "mids": [np.asarray(m) for m in aux["intermediates"]],
            "pruned": np.asarray(aux["pruned"]),
            "latency": aux["latency"], "grads": _to_numpy(grads)}


def _port_run(net, variables, x, gt, **kw):
    alphas = {k: v.clone().requires_grad_() for k, v in
              variables["alphas"].items()}
    theta = {s: {k: v.clone().requires_grad_() for k, v in d.items()}
             for s, d in variables["theta"].items()}
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = net({"alphas": alphas, "theta": theta,
                  "omega": variables["omega"]}, xt, return_aux=True, **kw)
    loss = torch.mean((y - torch.from_numpy(gt)) ** 2)
    leaves = ([xt] + list(alphas.values())
              + [t for d in theta.values() for t in d.values()])
    got = torch.autograd.grad(loss, leaves, materialize_grads=True)
    it = iter(got[1:])
    ga = {k: next(it).numpy() for k in alphas}
    gt_ = {s: {k: next(it).numpy() for k in d} for s, d in theta.items()}
    return {"loss": float(loss.detach()), "y": y.detach().numpy(),
            "mids": [m.detach().numpy() for m in aux["intermediates"]],
            "pruned": aux["pruned"].numpy(), "latency": aux["latency"],
            "grads": (ga, gt_, got[0].numpy())}


def _close_grad(got, want, name):
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_RTOL * scale,
                               err_msg=name)


def _assert_runs_match(port, ref):
    np.testing.assert_allclose(port["y"], ref["y"], atol=FWD_ATOL, rtol=0)
    for a, b in zip(port["mids"], ref["mids"]):
        np.testing.assert_allclose(a, b, atol=FWD_ATOL, rtol=0)
    np.testing.assert_array_equal(port["pruned"], ref["pruned"])
    (ga, gth, gx), (wa, wth, wx) = port["grads"], ref["grads"]
    for slot in wa:
        _close_grad(ga[slot], wa[slot], f"alphas[{slot}]")
    for slot in wth:
        assert sorted(gth[slot]) == sorted(wth[slot])
        for op in wth[slot]:
            _close_grad(gth[slot][op], wth[slot][op], f"theta[{slot}][{op}]")
    _close_grad(gx, wx, "input")


@pytest.fixture(scope="module")
def nets():
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = _nets(*CASES[case])
        return cache[case]

    return get


# ------------------------------------------------------------ forward, grads

@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_gradients_match_jax(nets, case):
    """Output, every slot's output, pruned counts and the gradients of a
    loss with respect to the alphas, theta and the input mosaic, at uniform
    init alphas."""
    jnet, np_vars, net, variables = nets(case)
    x, gt = _inputs()
    port = _port_run(net, variables, x, gt)
    _assert_runs_match(port, _jax_run(jnet, np_vars, x, gt))
    assert int(port["pruned"].sum()) == 0  # threshold x max keeps all


@pytest.mark.parametrize("case", ["srgb6", "srgb15"])
def test_pruning_kills_low_paths_as_jax(nets, case):
    """Alphas that leave step1's op 1 alone above 0.2 of the maximum, and a
    bayer slot with one path pruned: outputs, gradients and counts as
    JAX's; a pruned op's logits get an exact 0 (its output is multiplied by
    one)."""
    jnet, np_vars, net, variables = nets(case)
    k = len(np_vars["alphas"]["step1"])
    alphas = {"bayer": np.asarray([0.0, 3.0], np.float32),
              "step1": np.asarray([8.0] + [0.0] * (k - 1), np.float32)}
    np_vars = dict(np_vars, alphas=dict(np_vars["alphas"], **alphas))
    variables = dict(variables, alphas=dict(
        variables["alphas"], **{s: torch.from_numpy(a.copy())
                                for s, a in alphas.items()}))
    x, gt = _inputs(1)
    port = _port_run(net, variables, x, gt)
    _assert_runs_match(port, _jax_run(jnet, np_vars, x, gt))
    assert port["pruned"].tolist() == [1, 0, k - 1]
    for op, g in port["grads"][1]["step1"].items():
        assert (op == "gamma") == bool(np.any(g != 0.0)), op


def test_fused_bank_matches_unfused_and_jax(nets):
    """With proxies the 8 SRCNN-Res proxies of a slot run as one grouped
    conv stack; unfused they run one by one.  Both agree with each other
    (1e-5: the same convolutions, grouped) and with JAX's fused bank."""
    jnet, np_vars, net, variables = nets("srgb15_proxies")
    assert sum(net._bankable(s) for s in net.slots[2][1]) == 8
    x, gt = _inputs(2)
    fused = _port_run(net, variables, x, gt)
    unfused = _port_run(net, variables, x, gt, fuse_banks=False)
    np.testing.assert_allclose(fused["y"], unfused["y"], atol=1e-5, rtol=0)
    for slot in fused["grads"][0]:
        _close_grad(fused["grads"][0][slot], unfused["grads"][0][slot], slot)
    _assert_runs_match(fused, _jax_run(jnet, np_vars, x, gt))


def test_bank_of_one_runs_unfused(nets):
    """Natively only bm3d is bankable: a bank of one runs as a plain op, so
    fusing changes nothing, bit for bit."""
    _, _, net, variables = nets("srgb15")
    assert [s.name for s in net.slots[2][1] if net._bankable(s)] == ["bm3d"]
    x = torch.from_numpy(_inputs(3)[0])
    with torch.no_grad():
        assert torch.equal(net(variables, x),
                           net(variables, x, fuse_banks=False))


def test_remat_changes_nothing(nets):
    """torch.utils.checkpoint recomputes each op in the backward: the same
    arithmetic, so the same loss and gradients (1e-6 of each gradient's
    largest component, for any reordered accumulation)."""
    _, np_vars, net, variables = nets("srgb6")
    assert net.remat
    plain = SuperNet(1, 0.2, srgb_count=6, remat=False, device="cpu")
    x, gt = _inputs(4)
    a = _port_run(net, variables, x, gt)
    b = _port_run(plain, convert.supernet_variables_from_jax(np_vars, plain),
                  x, gt)
    assert a["loss"] == b["loss"]
    for slot in a["grads"][0]:
        np.testing.assert_allclose(a["grads"][0][slot], b["grads"][0][slot],
                                   rtol=0, atol=1e-6 * max(1e-12, float(
                                       np.abs(b["grads"][0][slot]).max())))
    np.testing.assert_allclose(a["grads"][2], b["grads"][2], rtol=0,
                               atol=1e-6 * float(np.abs(b["grads"][2]).max()))


# ---------------------------------------------------------------- latency

@pytest.fixture
def made_up_latency():
    """One made-up ms/MP table installed in both registries; both restored
    afterwards."""
    names = list(registry.LATENCY_MS_PER_MP)
    table = {name: 0.5 + 0.37 * i for i, name in enumerate(names)}
    port_before = dict(registry.LATENCY_MS_PER_MP)
    jax_before = {d: dict(jregistry.registry[d]) for d in jregistry.registry}
    latency.install(table)
    jlatency.install(table)
    yield table
    registry.LATENCY_MS_PER_MP.update(port_before)
    for d, entries in jax_before.items():
        jregistry.registry[d].clear()
        jregistry.registry[d].update(entries)


def test_expected_latency_matches_jax(made_up_latency):
    """Sum over slots of post-prune probability times ms/MP, and its
    gradient with respect to the alphas, as JAX's (1e-6 relative: float32
    sums in another order)."""
    jnet, np_vars, net, variables = _nets(6, False)
    np_vars["alphas"]["step1"] = np.linspace(-1, 1, 6).astype(np.float32)
    a = torch.from_numpy(np_vars["alphas"]["step1"].copy()).requires_grad_()
    variables["alphas"]["step1"] = a
    x = _inputs(5)[0]
    _, aux = net(variables, torch.from_numpy(x), return_aux=True)
    (ga,) = torch.autograd.grad(aux["latency"], a)

    def jax_latency(alpha):
        v = jax.tree.map(jnp.asarray, np_vars)
        v["alphas"]["step1"] = alpha
        return jnet(v, jnp.asarray(x), return_aux=True)[1]["latency"]

    want, wg = jax.value_and_grad(jax_latency)(
        jnp.asarray(np_vars["alphas"]["step1"]))
    assert float(aux["latency"].detach()) == pytest.approx(float(want),
                                                    rel=1e-6)
    np.testing.assert_allclose(ga.numpy(), np.asarray(wg), rtol=1e-5,
                               atol=1e-6)


def test_latency_is_none_while_an_entry_is_missing(nets, monkeypatch):
    _, _, net, variables = nets("srgb6")
    monkeypatch.setitem(registry.LATENCY_MS_PER_MP, "gamma", None)
    with torch.no_grad():
        _, aux = net(variables, torch.from_numpy(_inputs()[0]),
                     return_aux=True)
    assert aux["latency"] is None


# -------------------------------------------------------------- utilities

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_argmax_architecture_matches_jax(nets, seed):
    jnet, np_vars, net, variables = nets("srgb15")
    rng = np.random.default_rng(seed)
    alphas = {s: rng.standard_normal(a.shape).astype(np.float32)
              for s, a in np_vars["alphas"].items()}
    want = jnet.argmax_architecture(dict(np_vars, alphas=alphas))
    got = net.argmax_architecture(dict(variables, alphas={
        s: torch.from_numpy(a) for s, a in alphas.items()}))
    assert got == want
    assert net.slot_names == jnet.slot_names


@pytest.mark.parametrize("case", sorted(CASES))
def test_variables_round_trip(nets, case):
    """JAX -> port -> JAX gives back every array bit for bit."""
    _, np_vars, net, variables = nets(case)
    back = convert.supernet_variables_to_jax(variables)
    flat_a = jax.tree_util.tree_leaves_with_path(back)
    flat_b = jax.tree_util.tree_leaves_with_path(np_vars)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_init_layout_matches_jax(nets):
    """The port's own init has the JAX layout: the same slots, ops with
    logits, init logits and omega names."""
    _, np_vars, net, _ = nets("srgb15_proxies")
    v = net.init(torch.Generator().manual_seed(0))
    assert sorted(v["omega"]) == sorted(np_vars["omega"])
    for slot, ops in np_vars["theta"].items():
        assert sorted(v["theta"][slot]) == sorted(ops)
        for op, logits in ops.items():
            np.testing.assert_array_equal(v["theta"][slot][op].numpy(), logits)
    assert not any(p.requires_grad for m in v["omega"].values()
                   for p in m.parameters())


def test_supernet_defaults_to_cuda():
    """No device asked for: cuda, which raises here."""
    if torch.cuda.is_available():
        assert SuperNet(1, 0.2).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            SuperNet(1, 0.2)

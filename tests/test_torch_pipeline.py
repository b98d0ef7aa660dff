"""The port's pipelines, tiling and serving against the JAX package, with the
JAX pipeline's init weights carried across by convert.state_from_jax; every
op of the zoo, native and proxy; and the port's rules (no JAX import, no
silent CPU fallback)."""

import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import reconfigisp_tpu as rj
from reconfigisp_tpu.parallel import tiling as jtiling
from reconfigisp_tpu.utils.checkpoint import _to_numpy

import reconfigisp_tpu_torch as rt
from reconfigisp_tpu_torch import convert, deploy
from reconfigisp_tpu_torch.parallel import tiling
from reconfigisp_tpu_torch.utils.checkpoint import load_network

SLICE = "Bayer_01_Demosaic_03_sRGB_07_01_13_11"
SLICE2 = "Bayer_01_Demosaic_03_sRGB_08_09_01_13_11"   # median, then fast NLM
FLAGSHIP = "Bayer_01_Demosaic_03_sRGB_01_13_11"
CKPT = str(Path(__file__).resolve().parents[1] / "experiments" / "proxies"
           / "default.ckpt")


def _pair(arch, jax_state=None, use_proxy=False, seed=0):
    pj = rj.Pipeline(arch, use_proxy=use_proxy)
    st = jax_state or pj.init(jax.random.PRNGKey(seed))
    pt = rt.Pipeline(arch, use_proxy, device="cpu").load_state(
        convert.state_from_jax(_to_numpy(st)))
    return pj, st, pt


def _mosaic(shape, seed=21):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("arch", [SLICE, FLAGSHIP, SLICE2])
def test_pipeline_matches_jax_with_intermediates(arch):
    pj, st, pt = _pair(arch)
    x = _mosaic((2, 64, 64, 1))
    yj, mids_j, _ = pj(st, x, return_intermediates=True)
    with torch.no_grad():
        yt, mids_t, latency = pt(torch.from_numpy(x), return_intermediates=True)
    assert list(mids_t) == [name for name, _ in pj.steps]
    # the sum of the steps' ms/MP in the port's H100 table
    assert latency == pytest.approx(sum(
        spec.latency for _, spec in pt.steps), rel=1e-12)
    assert yt.shape == (2, 64, 64, 3)
    for (name, got), want in zip(mids_t.items(), mids_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   err_msg=name)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-4)


def test_flagship_matches_jax_on_graft_entry_input():
    """The slice-1 gate: the flagship on __graft_entry__.entry()'s input
    (1x512x512x1) with the same state."""
    import __graft_entry__
    fn, (st, x) = __graft_entry__.entry()
    pt = rt.Pipeline(FLAGSHIP, device="cpu").load_state(
        convert.state_from_jax(_to_numpy(st)))
    with torch.no_grad():
        got = pt(torch.tensor(np.asarray(x)))
    np.testing.assert_allclose(got.numpy(), np.asarray(fn(st, x)), atol=1e-4)


def test_slice_runs_the_expected_steps():
    pt = rt.Pipeline(SLICE, device="cpu")
    assert [n for n, _ in pt.steps] == [
        "step1_path_bayer", "step2_laplacian", "step3_bilateral",
        "step4_gamma", "step5_wbquadratic", "step6_wbmanual"]
    assert sorted(pt.logits) == ["step3_bilateral", "step4_gamma",
                                 "step5_wbquadratic", "step6_wbmanual"]


def _serve_tiled(pt, x):
    return tiling.tiled_apply(pt, x, patch=32, stride=24, chunk=4)


def _serve_fn(pt, x):
    return deploy.make_serving_fn(pt, patch=32, stride=24, chunk=4,
                                  device="cpu")(x)


@pytest.mark.parametrize("entry,arch", [
    ("tiled_apply", SLICE), ("make_serving_fn", SLICE),
    ("tiled_apply", SLICE2), ("make_serving_fn", SLICE2)], ids=[
    "tiled_apply", "make_serving_fn", "tiled_apply-slice2",
    "make_serving_fn-slice2"])
def test_tiled_serving_matches_jax(entry, arch):
    pj, st, pt = _pair(arch)
    x = _mosaic((1, 96, 128, 1), seed=22)
    want = jtiling.tiled_apply(lambda t: pj(st, t), jax.numpy.asarray(x),
                               patch=32, stride=24, chunk=4)
    run = {"tiled_apply": _serve_tiled, "make_serving_fn": _serve_fn}[entry]
    with torch.no_grad():
        got = run(pt, torch.from_numpy(x))
    assert got.shape == (1, 96, 128, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_tile_geometry_matches_jax():
    np.testing.assert_array_equal(tiling.feather_mask((32, 32), (4, 4)),
                                  jtiling.feather_mask((32, 32), (4, 4)))
    for total, size, stride in ((96, 32, 24), (2848, 512, 480),
                                (4256, 512, 480)):
        assert tiling.tile_positions(total, size, stride) == \
            jtiling.tile_positions(total, size, stride)


def test_default_bank_loads_through_convert():
    """The in-repo bank's trained path_bayer drives both pipelines alike."""
    bank = load_network(CKPT)
    pj = rj.Pipeline(SLICE)
    st = pj.init(jax.random.PRNGKey(0))
    st["weights"]["path_bayer"] = jax.tree.map(jax.numpy.asarray,
                                               bank["path_bayer"])
    pt = rt.Pipeline(SLICE, device="cpu").load_state(
        convert.state_from_jax({"weights": {"path_bayer": bank["path_bayer"]}}))
    sd = pt.weights["path_bayer"].state_dict()
    assert len(sd) == 28
    np.testing.assert_array_equal(
        sd["blocks.5.conv2.weight"].numpy(),
        bank["path_bayer"]["blocks"][5]["conv2"]["w"].transpose(3, 2, 0, 1))
    x = _mosaic((1, 32, 32, 1), seed=23)
    with torch.no_grad():
        got = pt(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(pj(st, x)), atol=1e-4)


def test_import_pulls_in_no_jax():
    code = ("import sys, reconfigisp_tpu_torch, reconfigisp_tpu_torch.deploy, "
            "reconfigisp_tpu_torch.convert, reconfigisp_tpu_torch.ops.tone, "
            "reconfigisp_tpu_torch.ops.conditional, "
            "reconfigisp_tpu_torch.ops.cnn, reconfigisp_tpu_torch.ops.denoise, "
            "reconfigisp_tpu_torch.ops.kernels.median, "
            "reconfigisp_tpu_torch.ops.kernels.fastnlm, chip_smoke; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'reconfigisp_tpu' "
            "or m.startswith('reconfigisp_tpu.')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert res.returncode == 0, res.stdout + res.stderr


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rt.Pipeline(SLICE)
    pt = rt.Pipeline(SLICE, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        deploy.make_serving_fn(pt, patch=32, stride=24)


def _zoo_arch(domain, idx):
    """A short pipeline around one op: nearest demosaic (which has no
    proxy) before an sRGB op, the sRGB skip after a demosaic op."""
    return {"bayer": f"Bayer_{idx:02d}_Demosaic_01_sRGB_10",
            "demosaic": f"Bayer_02_Demosaic_{idx:02d}_sRGB_10",
            "srgb": f"Bayer_02_Demosaic_01_sRGB_{idx:02d}"}[domain]


def _op_matches_jax(domain, idx):
    """The op through Pipeline natively and, where it has a proxy, with
    use_proxy=True, against the JAX pipeline at 1e-4 (conv sums run in
    another order) with the JAX init's weights and logits carried across."""
    arch = _zoo_arch(domain, idx)
    x = _mosaic((2, 32, 32, 1), seed=24)
    modes = [False]
    if rt.get_op(domain, idx).proxy_apply is not None:
        modes.append(True)
    for use_proxy in modes:
        pj, st, pt = _pair(arch, use_proxy=use_proxy, seed=idx)
        with torch.no_grad():
            got = pt(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(pj(st, x)),
                                   atol=1e-4, err_msg=f"use_proxy={use_proxy}")


@pytest.mark.parametrize("domain,idx", [
    ("demosaic", 4), ("srgb", 2), ("srgb", 3), ("srgb", 4), ("srgb", 8),
    ("srgb", 9), ("srgb", 14), ("srgb", 15), ("srgb", 16), ("srgb", 17),
    ("srgb", 18)])
def test_unported_op_raises(domain, idx):
    """These ops of the zoo build and run in the port, natively and as
    proxies, and match the JAX ops (_op_matches_jax)."""
    _op_matches_jax(domain, idx)


@pytest.mark.parametrize("domain,idx", [
    ("demosaic", 2), ("demosaic", 3), ("srgb", 6), ("srgb", 7)])
def test_op_and_proxy_match_jax(domain, idx):
    """The other ops with a proxy; test_torch_ops.py holds their native
    forms too."""
    _op_matches_jax(domain, idx)


@pytest.mark.parametrize("use_proxy", [False, True])
@pytest.mark.parametrize("domain", ["bayer", "demosaic", "srgb"])
def test_every_op_builds_with_the_jax_weights(domain, use_proxy):
    """Every op builds in both modes and owns the modules and logits the
    JAX pipeline's init makes, of the same shapes."""
    for spec in rt.pool(domain):
        arch = _zoo_arch(domain, rj.registry.op_index(domain, spec.name))
        st = _to_numpy(rj.Pipeline(arch, use_proxy=use_proxy).init(
            jax.random.PRNGKey(0)))
        pt = rt.Pipeline(arch, use_proxy, device="cpu")
        assert sorted(pt.weights) == sorted(st["weights"]), arch
        assert {k: tuple(v.shape) for k, v in pt.logits.items()} == \
            {k: v.shape for k, v in st["logits"].items()}, arch
        pt.load_state(convert.state_from_jax(st))


def test_bank_gives_each_pipeline_its_weights():
    """state_from_bank picks the native nets, the proxies in proxy mode and
    bm3d always; the result loads."""
    bank = load_network(CKPT)
    for arch, use_proxy, names in (
            (SLICE2, False, ["path_bayer"]),
            (SLICE2, True, ["fastnlm", "laplacian", "median", "path_bayer"]),
            ("Bayer_02_Demosaic_04_sRGB_15_12", False,
             ["bm3d", "demosaicnet", "path_bgr"])):
        pt = rt.Pipeline(arch, use_proxy, device="cpu")
        state = convert.state_from_bank(bank, pt)
        assert sorted(state["weights"]) == names
        pt.load_state(state)
    np.testing.assert_array_equal(
        pt.weights["bm3d"].conv1.weight.detach().numpy(),
        bank["bm3d"]["conv1"]["w"].transpose(3, 2, 0, 1))


def test_conditional_init_draws_small_weights_then_base_logits():
    pt = rt.Pipeline("Bayer_02_Demosaic_01_sRGB_17", device="cpu")
    flat = pt.logits["step3_conditional_wb_manual"].detach()
    assert flat.shape == (454,)
    np.testing.assert_allclose(flat[-3:].numpy(), [-1.38] * 3)
    assert 0.005 < float(flat[:-3].std()) < 0.015


def test_parse_architecture_matches_jax():
    for arch in (SLICE, FLAGSHIP, "Bayer_02_Demosaic_01_sRGB_05_06_12"):
        assert rt.parse_architecture(arch) == rj.parse_architecture(arch)
    with pytest.raises(ValueError):
        rt.parse_architecture("01_02")

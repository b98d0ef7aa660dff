"""The port's serving artifact (deploy.export_pipeline / load_pipeline), its
export CLI and the kernels as torch.library custom ops, on the CPU, against
the port's own make_serving_fn and the JAX package's deploy.py on the same
weights (carried across by convert.state_from_jax); and the storage default
RECONFIGISP_CNN_STORAGE sets in both packages."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

import reconfigisp_tpu as rj
from reconfigisp_tpu import deploy as jdeploy
from reconfigisp_tpu.utils import checkpoint as jcheckpoint
from reconfigisp_tpu.utils.checkpoint import _to_numpy

import reconfigisp_tpu_torch as rt
from reconfigisp_tpu_torch import convert, deploy
from reconfigisp_tpu_torch.ops.kernels import bilateral as kb
from reconfigisp_tpu_torch.ops.kernels import fastnlm as kf
from reconfigisp_tpu_torch.ops.kernels import median as km
from torch_one_thread import one_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
FLAGSHIP = "Bayer_01_Demosaic_03_sRGB_01_13_11"
SLICE = "Bayer_01_Demosaic_03_sRGB_07_01_13_11"      # bilateral
SLICE2 = "Bayer_01_Demosaic_03_sRGB_08_09_01_13_11"  # median, fast NLM
ARCHS = (FLAGSHIP, SLICE, SLICE2)
SHAPE = (1, 64, 64, 1)
TILING = {"patch": 32, "stride": 24}
KERNEL_OPS = {FLAGSHIP: set(), SLICE: {"reconfigisp.bilateral.default"},
              SLICE2: {"reconfigisp.median.default",
                       "reconfigisp.fastnlm.default"}}


def _mosaic(shape, seed=41):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


@pytest.fixture(scope="module")
def pairs():
    """arch -> (JAX pipeline, JAX state, port pipeline, port artifact),
    the artifact tiled at SHAPE."""
    out = {}
    for arch in ARCHS:
        pj = rj.Pipeline(arch)
        st = pj.init(jax.random.PRNGKey(3))
        pt = rt.Pipeline(arch, device="cpu").load_state(
            convert.state_from_jax(_to_numpy(st)))
        out[arch] = (pj, st, pt, deploy.export_pipeline(pt, SHAPE, **TILING))
    return out


def _serve(pt, x, **kw):
    return deploy.make_serving_fn(pt, device="cpu", **kw)(x)


@pytest.mark.parametrize("arch", ARCHS)
def test_artifact_round_trips_and_equals_serving_fn(pairs, arch, tmp_path):
    """From bytes and from a file, the loaded program equals make_serving_fn
    exactly on the CPU, and calls the kernels as custom ops."""
    _, _, pt, blob = pairs[arch]
    path = str(tmp_path / "a.rispt")
    deploy.save_artifact(path, blob)
    x = _mosaic(SHAPE)
    want = _serve(pt, x, **TILING)
    for src in (blob, path):
        loaded = deploy.load_pipeline(src, device="cpu")
        got = loaded(x)
        assert got.shape == (*SHAPE[:3], 3) and got.device.type == "cpu"
        assert torch.equal(got, want)
    ops = {str(n.target) for n in loaded._exported.graph.nodes
           if "reconfigisp" in str(n.target)}
    assert ops == KERNEL_OPS[arch]
    assert loaded.architecture == arch and loaded.input_shape == SHAPE


@pytest.fixture(scope="module")
def jax_flagship_artifact(pairs):
    pj, st, _, _ = pairs[FLAGSHIP]
    return jdeploy.export_pipeline(pj, st, SHAPE, platforms=["cpu"], **TILING)


@pytest.mark.parametrize("arch", ARCHS)
def test_artifact_matches_jax(pairs, jax_flagship_artifact, arch):
    """Within test_torch_pipeline.py's 1e-4 of JAX: its loaded artifact for
    the flagship, its jitted make_serving_fn for slices 1 and 2 (so that no
    JAX windowed op is exported on the CPU)."""
    pj, st, _, blob = pairs[arch]
    x = _mosaic(SHAPE, seed=42)
    if arch == FLAGSHIP:
        want = jdeploy.load_pipeline(jax_flagship_artifact)(x)
    else:
        want = jax.jit(jdeploy.make_serving_fn(pj, st, **TILING))(x)
    got = deploy.load_pipeline(blob, device="cpu")(x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_weights_are_baked_in(pairs):
    """Zeroing the source pipeline's parameters changes its serving output
    but not the artifact's."""
    _, st, _, blob = pairs[SLICE2]
    pt = rt.Pipeline(SLICE2, device="cpu").load_state(
        convert.state_from_jax(_to_numpy(st)))
    x = _mosaic(SHAPE, seed=43)
    before = _serve(pt, x, **TILING)
    loaded = deploy.load_pipeline(blob, device="cpu")
    with torch.no_grad():
        for p in pt.parameters():
            p.zero_()
    assert not torch.equal(_serve(pt, x, **TILING), before)
    assert torch.equal(loaded(x), before)


def test_symbolic_batch_serves_any_batch(pairs):
    """Whole-frame with batch "b": one artifact at batch 1, 2 and 3; with
    patch set it raises, as in the JAX package."""
    _, _, pt, _ = pairs[FLAGSHIP]
    blob = deploy.export_pipeline(pt, ("b", 32, 48, 1))
    loaded = deploy.load_pipeline(blob, device="cpu")
    assert loaded.input_shape == ("b", 32, 48, 1)
    for n in (1, 2, 3):
        x = _mosaic((n, 32, 48, 1), seed=44 + n)
        assert torch.equal(loaded(x), _serve(pt, x))
    for export, args in ((deploy.export_pipeline, (pt,)),
                         (jdeploy.export_pipeline, pairs[FLAGSHIP][:2])):
        with pytest.raises(ValueError, match="symbolic batch"):
            export(*args, (-1, 64, 64, 1), **TILING)


def test_wrong_shape_is_rejected(pairs):
    loaded = deploy.load_pipeline(pairs[FLAGSHIP][3], device="cpu")
    for shape in ((1, 32, 64, 1), (2, 64, 64, 1), (64, 64, 1)):
        with pytest.raises(ValueError, match="artifact serves"):
            loaded(np.zeros(shape, np.float32))


def test_header_fields_equal_jax(pairs):
    """The same export in both packages, bf16 storage, platforms cpu: every
    header field equal."""
    pj, st, pt, _ = pairs[FLAGSHIP]
    kw = dict(patch=32, stride=24, chunk=4, storage="bf16",
              platforms=["cpu"])
    ours = deploy.split_artifact(deploy.export_pipeline(pt, SHAPE, **kw))[0]
    blob = jdeploy.export_pipeline(pj, st, SHAPE, **kw)
    theirs = jdeploy.load_pipeline(blob).meta
    assert ours == theirs
    assert ours["cnn_storage"] == "bfloat16"
    whole = deploy.export_pipeline(pt, ("b", 16, 16, 1), platforms=["gpu"])
    meta = deploy.split_artifact(whole)[0]
    assert meta["input_shape"] == ["b", 16, 16, 1]
    assert (meta["patch"], meta["stride"], meta["chunk"]) == (None,) * 3
    assert meta["platforms"] == ["cuda"] and meta["cnn_storage"] == "float32"
    with pytest.raises(ValueError, match="exported for"):
        deploy.load_pipeline(whole, device="cpu")
    with pytest.raises(ValueError, match="platform 'tpu'"):
        deploy.export_pipeline(pt, SHAPE, platforms=["tpu"])


def test_each_loader_rejects_the_others_magic(pairs, jax_flagship_artifact):
    with pytest.raises(ValueError,
                       match="not a reconfigisp_tpu_torch serving artifact"):
        deploy.load_pipeline(jax_flagship_artifact, device="cpu")
    with pytest.raises(ValueError,
                       match="not a reconfigisp_tpu serving artifact"):
        jdeploy.load_pipeline(pairs[FLAGSHIP][3])


def test_mesh_raises(pairs):
    """A mesh with patch: ValueError, as in the JAX package, on either
    axis; a height the space axis does not divide: ValueError; a mesh
    artifact loaded without a group of as many ranks: ValueError with the
    JAX package's message (a rank for a device).  Serving them over two
    and four ranks: tests/test_torch_dp.py, tests/test_torch_space.py."""
    pt = pairs[FLAGSHIP][2]
    with pytest.raises(ValueError, match="whole-frame only"):
        deploy.export_pipeline(pt, SHAPE, data_parallel=2, **TILING)
    with pytest.raises(ValueError, match="whole-frame only"):
        deploy.export_pipeline(pt, SHAPE, space_parallel=2, **TILING)
    with pytest.raises(ValueError, match="does not split"):
        deploy.export_pipeline(pt, (2, 66) + tuple(SHAPE[2:]),
                               space_parallel=4)
    blob = deploy.export_pipeline(pt, (2,) + tuple(SHAPE[1:]),
                                  data_parallel=2)
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        deploy.load_pipeline(blob, device="cpu")
    # a pipeline without convolutions: the export is fast
    blob = deploy.export_pipeline(
        rt.Pipeline("Bayer_02_Demosaic_01_sRGB_01", device="cpu"),
        (2,) + tuple(SHAPE[1:]), data_parallel=2, space_parallel=2)
    assert deploy.split_artifact(blob)[0]["mesh"] == {"data": 2, "space": 2}
    with pytest.raises(ValueError, match="needs 4 devices, have 1"):
        deploy.load_pipeline(blob, device="cpu")


def _run(code, env=None, timeout=240):
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=timeout, cwd=ROOT,
                         env=dict(os.environ, **(env or {})))
    assert res.returncode == 0, res.stdout + res.stderr
    return res.stdout


def test_serving_process_imports_no_jax_and_no_pipeline(pairs, tmp_path):
    """A process that loads and serves slice 2's artifact imports neither
    jax nor the JAX package, nor the port's pipeline or op registry, and
    runs the CPU forms of the kernel ops."""
    path = tmp_path / "slice2.rispt"
    deploy.save_artifact(str(path), pairs[SLICE2][3])
    np.save(tmp_path / "x.npy", _mosaic(SHAPE, seed=45))
    out = _run(
        "import sys, numpy as np, torch\n"
        "from reconfigisp_tpu_torch import deploy\n"
        f"p = deploy.load_pipeline({str(path)!r}, device='cpu')\n"
        f"y = p(np.load({str(tmp_path / 'x.npy')!r}))\n"
        f"torch.save(y, {str(tmp_path / 'y.pt')!r})\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'reconfigisp_tpu') or m in ('reconfigisp_tpu_torch.pipeline',"
        " 'reconfigisp_tpu_torch.registry')]\n"
        "print('BAD', bad)\n")
    assert "BAD []" in out, out
    want = _serve(pairs[SLICE2][2], np.load(tmp_path / "x.npy"), **TILING)
    assert torch.equal(torch.load(tmp_path / "y.pt"), want)


def test_export_cli(pairs, tmp_path):
    """python -m reconfigisp_tpu_torch.export on a config whose test set
    sets the tiling, with a network checkpoint the JAX package wrote: the
    artifact takes the config's patch and stride and serves that network."""
    _, st, pt, _ = pairs[SLICE]
    ckpt = jcheckpoint.save_network(str(tmp_path), "G", "latest", st)
    opt = {"name": "export_cli", "model": "isp",
           "datasets": {"test": {"mode": "synthetic", "n": 1,
                                 "data_size": 64, "patch_size": 32,
                                 "patch_stride": 24}},
           "network_G": {"which_model_G": "Pipeline", "architecture": SLICE},
           "path": {"root": str(tmp_path), "pretrain_model_G": ckpt}}
    (tmp_path / "opt.yaml").write_text(yaml.safe_dump(opt))
    out = str(tmp_path / "a.rispt")
    res = subprocess.run(
        [sys.executable, "-m", "reconfigisp_tpu_torch.export", "--opt",
         str(tmp_path / "opt.yaml"), "--shape", "1x64x64x1", "--chunk", "4",
         "--device", "cpu", "--out", out],
        capture_output=True, text=True, timeout=240, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert res.returncode == 0, res.stdout + res.stderr
    assert f"loaded {ckpt}" in res.stdout and "patch 32/24" in res.stdout
    loaded = deploy.load_pipeline(out, device="cpu")
    assert (loaded.meta["patch"], loaded.meta["stride"],
            loaded.meta["chunk"]) == (32, 24, 4)
    x = _mosaic(SHAPE, seed=46)
    assert torch.equal(loaded(x), _serve(pt, x, chunk=4, **TILING))


_OPS = {"bilateral": (kb, 3), "median": (km, 1), "fastnlm": (kf, 3)}


@pytest.mark.parametrize("name", sorted(_OPS))
def test_opcheck_on_the_cpu(name):
    """torch.library.opcheck: schema, autograd registration, the fake
    implementation against the CPU one, and AOT autograd's forward and
    gradient against eager."""
    mod, n_params = _OPS[name]
    x = torch.from_numpy(_mosaic((2, 16, 20, 3), seed=47)).requires_grad_()
    p = torch.tensor([[0.3, 0.4, 0.5][:n_params], [0.6, 0.2, 0.1][:n_params]])
    torch.library.opcheck(mod.op, (x, p.requires_grad_(name != "median")))


@pytest.mark.parametrize("name", sorted(_OPS))
def test_op_gradient_is_the_plain_forms(name):
    """The op's autograd (its backward op) gives the plain form's autograd
    gradient, bit for bit; the wrapper runs the plain form itself for a
    CPU input that requires grad, and the op otherwise."""
    mod, n_params = _OPS[name]
    plain = getattr(mod, f"{name}_plain")
    rng = np.random.default_rng(48)
    x = torch.from_numpy(rng.uniform(0, 1, (3, 40, 36, 3)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    p = torch.tensor([[0.9, 0.2, 0.3][:n_params], [0.5, 0.6, 0.1][:n_params],
                      [0.2, 0.4, 0.8][:n_params]])
    needs_p = name != "median"
    grads = []
    for fn in (mod.op, plain):
        xs, ps = x.clone().requires_grad_(), p.clone().requires_grad_(needs_p)
        out = fn(xs, ps)
        grads.append(torch.autograd.grad(out, [xs, ps][:1 + needs_p], g))
    for got, want in zip(*grads):
        assert torch.equal(got, want)
    xs = x.clone().requires_grad_()
    assert "reconfigisp" not in type(getattr(mod, name)(xs, p).grad_fn).__name__
    assert "reconfigisp" in type(mod.op(xs, p).grad_fn).__name__
    with torch.no_grad():
        assert torch.equal(getattr(mod, name)(xs, p), plain(x, p))


@pytest.mark.parametrize("name", sorted(_OPS))
def test_op_saves_no_tensors_and_refuses_changed_inputs(name):
    """The op's autograd keeps its inputs without saving tensors, so a
    checkpoint around it (the supernet's per-op remat) has nothing to
    recompute and launches no kernel again; an input changed in place
    before the backward raises."""
    mod, n_params = _OPS[name]
    x = torch.from_numpy(_mosaic((1, 16, 16, 3), seed=49)).requires_grad_()
    p = torch.full((1, n_params), 0.4, requires_grad=name != "median")
    packed = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: packed.append(t) or t, lambda t: t):
        xs = x * 1.0
        out = mod.op(xs, p)
    assert packed == [] and out.requires_grad
    xs.mul_(0.5)
    with pytest.raises(RuntimeError, match="modified in place"):
        out.sum().backward()


def test_storage_default_follows_the_environment_as_jax():
    """RECONFIGISP_CNN_STORAGE sets the default storage in both packages:
    bf16 gives bfloat16, an unknown name float32."""
    code = ("import jax; jax.config.update('jax_platforms', 'cpu')\n"
            "import jax.numpy as jnp\n"
            "from reconfigisp_tpu import precision as j\n"
            "from reconfigisp_tpu_torch import precision as t\n"
            "print('DTYPES', jnp.dtype(j.cnn_storage_dtype()).name, "
            "str(t.cnn_storage_dtype()).removeprefix('torch.'))\n")
    for value, want in (("bf16", "bfloat16"), ("nonsense", "float32")):
        out = _run(code, env={"RECONFIGISP_CNN_STORAGE": value})
        assert f"DTYPES {want} {want}" in out, (value, out)

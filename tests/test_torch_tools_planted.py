"""The port's planted demo and ft-divergence tools
(reconfigisp_tpu_torch/tools/planted_demo.py, ft_divergence.py) against the
JAX tools of tools/: ablations and architecture strings equal, the
cross-seed aggregates and the ft gap reproduce the JAX results file
exactly, held-out PSNR within 1e-3 dB on one converted state, and both
tools end to end on the CPU at the smallest budgets, every leg, into a
temporary directory, with the JAX file's keys."""

import copy
import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest

import reconfigisp_tpu as rj
from reconfigisp_tpu.utils.checkpoint import _to_numpy

import reconfigisp_tpu_torch as rt
from reconfigisp_tpu_torch import convert
from reconfigisp_tpu_torch.pipeline import parse_architecture
from reconfigisp_tpu_torch.tools import ft_divergence, planted_demo
from reconfigisp_tpu_torch.utils.checkpoint import load_network
from torch_one_thread import one_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
JAX_RESULTS = REPO / "experiments" / "planted" / "results.json"
BANK = REPO / "experiments" / "proxies" / "default.ckpt"
PSNR_TOL_DB = 1e-3


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"{name}_under_test", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_demo():
    return _jax_tool("planted_demo")


@pytest.mark.parametrize("arch", [
    "Bayer_01_Demosaic_03_sRGB_13_13_13",
    "Bayer_01_Demosaic_03_sRGB_13_13_04",
    "Bayer_01_Demosaic_03_sRGB_11_01_10",
    "Bayer_02_Demosaic_04_sRGB_10_07_10_13",
])
def test_ablations_and_format_match_jax(jax_demo, arch):
    from reconfigisp_tpu.pipeline import parse_architecture as jparse
    got = planted_demo.ablations_of(arch)
    assert got == jax_demo.ablations_of(arch)
    assert list(got) == list(jax_demo.ablations_of(arch))
    assert planted_demo._format(parse_architecture(arch)) == \
        jax_demo._format(jparse(arch)) == arch
    for abl in got.values():   # every ablation builds in the port
        rt.Pipeline(abl, device="cpu")


def test_aggregate_and_ft_gap_reproduce_the_jax_results():
    stored = json.loads(JAX_RESULTS.read_text())
    results = {"seeds": copy.deepcopy(stored["seeds"])}
    assert planted_demo.aggregate(results, [0, 1, 2])
    for key in ("margin_db_per_seed", "margin_db_mean", "margin_db_std",
                "native_archs_across_seeds", "all_legs_agree_per_seed",
                "all_legs_recover_planted_per_seed", "seeds_finished",
                "seeds_pending"):
        assert results[key] == stored[key], key
    assert results["step2_psnr"] == stored["seeds"]["0"]["step2_psnr"]
    gap = ft_divergence.ft_gap(results, sorted(results["seeds"]))
    assert gap == stored["ft_divergence_psnr_gap_db"]
    # no seed finished: nothing to aggregate; no leg table: no gap
    assert not planted_demo.aggregate({"seeds": {}}, [0])
    assert ft_divergence.ft_gap({"seeds": {"0": {}}}, ["0"]) is None


def test_eval_psnr_matches_jax_on_one_state(jax_demo):
    """Held-out PSNR of both packages on the same state: the JAX init with
    the bank's path_bayer, carried across by convert.state_from_jax; n = 2
    frames of 32x32 (the JAX convs at HIGHEST precision, f32 like torch's)."""
    arch = "Bayer_01_Demosaic_03_sRGB_07_11_01"
    bank = load_network(str(BANK))
    st = rj.Pipeline(arch).init(jax.random.PRNGKey(3))
    st["weights"]["path_bayer"] = jax.tree.map(jax.numpy.asarray,
                                               bank["path_bayer"])
    pipe = rt.Pipeline(arch, device="cpu").load_state(
        convert.state_from_jax(_to_numpy(st)))
    with jax.default_matmul_precision("highest"):
        want = jax_demo.eval_psnr(arch, st, n=2, size=32)
    got = planted_demo.eval_psnr(pipe, n=2, size=32)
    assert np.isfinite(got) and 5.0 < got < 60.0
    assert abs(got - want) <= PSNR_TOL_DB, (got, want)


def _keys(tree, depth):
    """The nested key names of a results dict, `depth` levels down."""
    if depth == 0 or not isinstance(tree, dict):
        return None
    return {k: _keys(v, depth - 1) for k, v in tree.items()}


def test_tools_end_to_end_on_the_cpu(tmp_path):
    """The demo at the smallest budgets, every leg (1 search step each, the
    ft leg's tuning round firing, 2 step-2 steps, 2 held-out frames), then
    ft_divergence, into tmp_path; the file is strict JSON with the JAX
    file's keys (step 2 also records its probe loss before and after and
    its logits' largest move), and nothing is written under the checkout's experiments/."""
    before = sorted(p.name for p in (REPO / "experiments").iterdir())
    out = tmp_path / "planted"
    planted_demo.main([
        "--device", "cpu", "--seeds", "0", "--pretrain-steps", "1",
        "--search-iters", "1", "--ft-interval", "1", "--isp-iters", "2",
        "--eval-frames", "2", "--out", str(out)])
    ft_divergence.main(["--device", "cpu", "--isp-iters", "2",
                        "--eval-frames", "2", "--out", str(out)])
    assert sorted(p.name for p in (REPO / "experiments").iterdir()) == before
    assert (out / "proxies.ckpt").exists()
    assert (out / "experiments" / "planted_search" / "models").is_dir()
    got = json.loads((out / "results.json").read_text(),
                     parse_constant=lambda c: pytest.fail(f"bare {c}"))
    stored = json.loads(JAX_RESULTS.read_text())

    assert set(got) == set(stored) | {"device"}
    assert got["device"] == {"type": "cpu"}
    seed, jseed = got["seeds"]["0"], stored["seeds"]["0"]
    assert set(seed) == set(jseed)
    for leg in ("native", "proxy", "ft"):
        assert _keys(seed[f"search_{leg}"], 1) == _keys(
            jseed[f"search_{leg}"], 1)
        assert seed[f"search_{leg}"]["iters"] == 1
        assert np.isfinite(seed[f"search_{leg}"]["loss"])
    assert set(seed["leg_arch_psnr"]) == set(jseed["leg_arch_psnr"])
    assert set(seed["step2_psnr"]) == {
        "searched", *planted_demo.ablations_of(
            seed["search_native"]["architecture"])}
    for rec in [*seed["step2_psnr"].values(),
                *seed["leg_arch_psnr"].values()]:
        assert set(rec) == set(jseed["step2_psnr"]["searched"]) | {
            "probe_loss_start", "probe_loss_final", "logits_moved"}
        assert all(np.isfinite(v) for k, v in rec.items()
                   if k != "architecture")
    assert got["ft_divergence_psnr_gap_db"]["per_seed"].keys() == {"0"}


def test_tools_import_no_jax_and_no_jax_tool():
    """The three tools pull in neither JAX, nor the JAX package, nor a
    module of the repo's tools/."""
    import subprocess
    import sys
    code = ("import sys; sys.path.insert(0, '.'); "
            "import reconfigisp_tpu_torch.tools.planted_demo, "
            "reconfigisp_tpu_torch.tools.ft_divergence, "
            "reconfigisp_tpu_torch.tools.rehearse_real_scale; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'reconfigisp_tpu', 'tools', 'planted_demo', "
            "'ft_divergence', 'rehearse_real_scale')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr

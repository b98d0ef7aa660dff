"""The port's planted demo and ft-divergence tools
(reconfigisp_tpu_torch/tools/planted_demo.py, ft_divergence.py) against the
JAX tools of tools/: ablations and architecture strings equal, each seed's
and leg's search options equal, the cross-seed aggregates and the ft gap
reproduce both packages' committed results files exactly, a sweep resumed
over a finished seed runs nothing of it, held-out PSNR within 1e-3 dB on
one converted state, and both tools end to end on the CPU at the smallest
budgets, every leg, into a temporary directory, with the JAX file's
keys."""

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
PORT_RESULTS = REPO / "experiments" / "planted_torch" / "results.json"
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


@pytest.mark.parametrize("path", [JAX_RESULTS, PORT_RESULTS],
                         ids=["jax", "port"])
def test_aggregate_and_ft_gap_reproduce_the_jax_results(path):
    """Each file's stored aggregates are `aggregate`'s and `ft_gap`'s of its
    own seeds: the JAX tool's file, and the port's from the card."""
    stored = json.loads(path.read_text())
    results = {"seeds": copy.deepcopy(stored["seeds"])}
    assert planted_demo.aggregate(results,
                                  sorted(int(s) for s in stored["seeds"]))
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


SEARCHED = "Bayer_01_Demosaic_03_sRGB_13_13_04"
LEG_CONFIGS = (("native", "planted_search"), ("proxy", "planted_search_proxy"),
               ("ft", "planted_search_ft"))


def _leg_record(iters, loss=1e-3):
    return {"architecture": SEARCHED, "loss": loss, "val_loss": loss,
            "iters": iters, "seconds": 0.0}


def _search_stub(calls):
    """A run_training that records the options it is given."""
    def run_training(opt, max_iters, device=None):
        calls.append(opt)
        return {"architecture": SEARCHED, "loss": 1e-3, "val_loss": 2e-3,
                "steps_run": max_iters}
    return run_training


@pytest.mark.parametrize("leg", ["native", "proxy", "ft"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_search_options_per_seed_match_jax(jax_demo, monkeypatch, tmp_path,
                                           seed, leg):
    """One leg of one seed through both tools' run_one_seed, the other legs
    cached and the search and step 2 stubbed, fresh and again after a
    finished leg with a non-finite loss: the same experiment name (per seed
    past seed 0), manual_seed (offset by the seed), resume (off for the
    re-run), proxies (each tool's <out>/proxies.ckpt) and darts_ft tuning
    interval; the port's --ft-interval overrides the ft leg's alone."""
    import reconfigisp_tpu.search.trainer as jax_trainer
    monkeypatch.chdir(REPO)
    jax_calls, port_calls = [], []
    monkeypatch.setattr(jax_trainer, "run_training", _search_stub(jax_calls))
    monkeypatch.setattr(planted_demo, "run_training",
                        _search_stub(port_calls))
    monkeypatch.setattr(jax_demo, "train_fixed",
                        lambda *a, **k: (None, {"loss": 1e-3}))
    monkeypatch.setattr(jax_demo, "eval_psnr", lambda *a, **k: 30.0)
    monkeypatch.setattr(planted_demo, "train_fixed",
                        lambda *a, **k: (None, {"loss": 1e-3}))
    monkeypatch.setattr(planted_demo, "eval_psnr", lambda *a, **k: 30.0)
    iters, name = 3, dict(LEG_CONFIGS)[leg]
    name += f"_seed{seed}" if seed else ""
    for rerun in (False, True):
        prior = {f"search_{other}": _leg_record(iters)
                 for other, _ in planted_demo.LEGS if other != leg}
        if rerun:
            prior[f"search_{leg}"] = _leg_record(iters, loss=float("nan"))
        jax_calls.clear()
        port_calls.clear()
        jax_demo.run_one_seed(seed, iters, 2, copy.deepcopy(prior),
                              lambda res: None)
        planted_demo.run_one_seed(seed, iters, 2, copy.deepcopy(prior),
                                  lambda res: None, out=str(tmp_path),
                                  device="cpu")
        (want,), (got,) = jax_calls, port_calls
        assert got["name"] == want["name"] == name
        assert got["train"]["manual_seed"] == \
            want["train"]["manual_seed"] == 10 + seed
        assert got["train"]["resume"] == want["train"]["resume"]
        assert (got["train"]["resume"] is False) == rerun
        assert Path(got["path"]["experiments_root"]).relative_to(tmp_path) \
            == Path(want["path"]["experiments_root"]).relative_to(REPO) \
            == Path("experiments", name)
        assert want["path"]["pretrain_proxies"] == jax_demo.PROXIES
        assert got["path"]["pretrain_proxies"] == str(
            tmp_path / "proxies.ckpt")
        assert (got["proxy_ft_params"] or {}).get("ft_interval") == \
            (want["proxy_ft_params"] or {}).get("ft_interval")
    cfg = dict(planted_demo.LEGS)[leg]
    tuned = planted_demo._search_options(cfg, seed, str(tmp_path), "p",
                                         False, 7)
    assert (tuned["proxy_ft_params"] or {}).get("ft_interval") == (
        7 if leg == "ft" else None)


def test_a_sweep_over_a_finished_seed_runs_nothing_of_it(monkeypatch,
                                                         tmp_path, capsys):
    """`--seeds 0`, then `--seeds 0,1` over its results file, the search
    and step 2 stubbed: the second run searches and trains seed 1 alone,
    reuses each of seed 0's legs, and aggregates both seeds."""
    searches, trained = [], []

    def train_fixed(arch, niter, *, seed=0, **kw):
        trained.append(seed)
        return arch, {"loss": 1e-3}

    monkeypatch.setattr(planted_demo, "run_training", _search_stub(searches))
    monkeypatch.setattr(planted_demo, "train_fixed", train_fixed)
    monkeypatch.setattr(planted_demo, "eval_psnr",
                        lambda pipe, n=16: 36.0 if pipe == SEARCHED else 35.0)
    args = ["--device", "cpu", "--skip-pretrain", "--search-iters", "2",
            "--isp-iters", "2", "--eval-frames", "1", "--out", str(tmp_path)]
    planted_demo.main(["--seeds", "0", *args])
    assert [opt["name"] for opt in searches] == [
        config for _, config in LEG_CONFIGS]
    assert set(trained) == {0}
    first = json.loads((tmp_path / "results.json").read_text())["seeds"]["0"]
    searches.clear()
    trained.clear()
    capsys.readouterr()
    planted_demo.main(["--seeds", "0,1", *args])
    assert [opt["name"] for opt in searches] == [
        f"{config}_seed1" for _, config in LEG_CONFIGS]
    assert [opt["train"]["manual_seed"] for opt in searches] == [11] * 3
    assert trained and set(trained) == {1}
    log = capsys.readouterr().out
    for leg, _ in LEG_CONFIGS:
        assert f"seed 0: reusing cached {leg} search (2 iters)" in log
    got = json.loads((tmp_path / "results.json").read_text())
    assert got["seeds"]["0"] == first
    assert got["seeds_finished"] == 2 and got["seeds_pending"] == 0
    assert got["margin_db_per_seed"] == {"0": 1.0, "1": 1.0}


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

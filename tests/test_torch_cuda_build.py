"""The hand kernels' builds for the card: every csrc/*.cu library compiles
for sm_90a without spilling, and so does each of the median's and the
bilateral's bodies, one kernel per channel count C and radius (their
sources built with -DMEDIAN_BODY_KERNELS and -DBILATERAL_BODY_KERNELS into
cubins); where cuobjdump is present, each body's SASS holds the
instructions of its design: the median's integer min/max of its pruned
selection networks (ops/kernels/median.MEDIAN_NETWORK_MINMAX), the
bilateral's MUFU.EX2 of one column offset's taps
(ops/kernels/bilateral.BILATERAL_ROWS).

Needs nvcc and an NVIDIA GPU; every test skips without a card.  The file
imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_build.py
"""

import re
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from reconfigisp_tpu_torch.ops.kernels import _build
from reconfigisp_tpu_torch.ops.kernels import bilateral as kb
from reconfigisp_tpu_torch.ops.kernels import median as km

pytestmark = pytest.mark.cuda

# csrc/<name>.cu built with -D<macro> holds one kernel per C and radius
BODY_MACROS = {"median": "MEDIAN_BODY_KERNELS",
               "bilateral": "BILATERAL_BODY_KERNELS"}
BODIES = [(c, r) for c in (1, 3) for r in range(1, 8)]


@pytest.fixture(scope="module")
def nvcc():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return _build.nvcc()


def _spills(ptxas_output: str) -> list:
    return re.findall(r"[1-9]\d* bytes spill \w+", ptxas_output)


@pytest.mark.parametrize("name", ["bilateral", "median", "fastnlm"])
def test_library_builds_without_spills(nvcc, name, tmp_path):
    """csrc/<name>.cu with the library's own flags: nvcc succeeds and
    ptxas reports no spill in any kernel."""
    proc = subprocess.run(
        [nvcc, *_build.NVCC_FLAGS, "-o", str(tmp_path / f"{name}.so"),
         str(_build.CSRC / f"{name}.cu")],
        capture_output=True, text=True, timeout=600)
    output = proc.stdout + proc.stderr
    assert proc.returncode == 0, output[-3000:]
    assert not _spills(output), output


def _body_key(name: str, symbol: str):
    """(C, radius) of a mangled <name>_kernel<C, R> name, or None."""
    m = re.search(name + r"_kernelILi(\d)ELi(\d)EE", symbol)
    return (int(m[1]), int(m[2])) if m and m[2] != "0" else None


@pytest.fixture(scope="module")
def bodies(nvcc, tmp_path_factory):
    """{name: (cubin, {(C, radius): ptxas's lines for that body})}, one
    cubin per source, built at once."""
    root = tmp_path_factory.mktemp("bodies")
    flags = [f for f in _build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    procs = {name: subprocess.Popen(
        [nvcc, *flags, "-cubin", f"-D{macro}", "-o",
         str(root / f"{name}.cubin"), str(_build.CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, macro in BODY_MACROS.items()}
    out = {}
    for name, proc in procs.items():
        output, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, output[-3000:]
        report, current = {}, None
        for line in output.splitlines():
            m = re.search(r"entry function '([^']+)'|"
                          r"Function properties for (\S+)", line)
            if m:
                current = _body_key(name, m[1] or m[2])
            elif current is not None:
                report.setdefault(current, []).append(line)
        out[name] = (root / f"{name}.cubin", report)
    return out


@pytest.mark.parametrize("name", sorted(BODY_MACROS))
def test_bodies_build_without_spills(bodies, name):
    """ptxas reports every body, at C = 1 and 3 and radii 1-7, with its
    registers and no spill."""
    _, report = bodies[name]
    assert sorted(report) == BODIES
    for key, lines in report.items():
        text = "\n".join(lines)
        assert re.search(r"Used \d+ registers", text), (key, text)
        assert not _spills(text), (key, text)


def _sass_counts(name: str, cubin: Path, pattern: str) -> dict:
    """{(C, radius): {group: count}} of the SASS instructions of each body
    that match `pattern`, counted by its first group."""
    tool = shutil.which("cuobjdump") or str(
        Path(_build.nvcc()).with_name("cuobjdump"))
    if not Path(tool).is_file():
        pytest.skip("cuobjdump is not installed")
    sass = subprocess.run([tool, "-sass", str(cubin)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, current = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = _body_key(name, m[1])
            if current is not None:
                counts[current] = {}
            continue
        op = re.search(pattern, line)
        if current is not None and op:
            counts[current][op[1]] = counts[current].get(op[1], 0) + 1
    return counts


def test_median_networks_are_pruned_in_the_sass(bodies):
    """The integer min/max of each network body (two-input IMNMX or VIMNMX,
    and the three-input VIMNMX3 that ptxas fuses from a min of a min, as
    two), less those of the same C's radius-7 bisection body (the
    staging's reflections), are its pruned network's, or a few more: at
    most MEDIAN_NETWORK_MINMAX + 8."""
    counts = _sass_counts("median", bodies["median"][0],
                          r"\bV?IMNMX(3?)[.\s]")
    assert sorted(counts) == BODIES
    for (c, r), want in ((k, km.MEDIAN_NETWORK_MINMAX[k[1]])
                         for k in BODIES if k[1] in km.MEDIAN_NETWORK_MINMAX):
        got = (counts[c, r].get("", 0) + 2 * counts[c, r].get("3", 0)
               - counts[c, 7].get("", 0))
        assert got <= want + 8, (c, r, got, want)


def test_bilateral_exps_follow_the_design_in_the_sass(bodies):
    """Each bilateral body issues one column offset's taps, BILATERAL_ROWS
    (2R+1) C MUFU.EX2: one exp per tap."""
    counts = _sass_counts("bilateral", bodies["bilateral"][0],
                          r"\bMUFU\.(EX2)\b")
    assert sorted(counts) == BODIES
    for c, r in BODIES:
        assert counts[c, r].get("EX2") == kb.BILATERAL_ROWS * (2 * r + 1) * c

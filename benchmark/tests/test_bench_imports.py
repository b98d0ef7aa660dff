"""What the benchmark runs loads neither JAX nor the JAX package, and the
plain reference loads nothing of the port, checked by each loaded module's
top-level name (the part before the first dot, compared whole: the port's
name begins with the JAX package's).

    python -m pytest benchmark/tests/test_bench_imports.py -q
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.lib import spec  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "reconfigisp_tpu"}
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def _loaded(code: str) -> set:
    """Top-level names of the modules a fresh interpreter holds after
    `code`."""
    probe = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); {code}; "
             "import json; print(json.dumps(sorted({m.split('.')[0] "
             "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=300).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def _run_modules() -> list:
    """Everything a run executes: the entry, the systems with what their
    set-up imports of the port, the generators and the metric readers."""
    files = ["benchmark/run.py", "benchmark/control.py", "benchmark/sets.py"]
    for w in BENCH["workloads"]:
        cell = spec.load(w["name"])
        files.append(f"benchmark/systems/{cell.config['system']}.py")
        files.append(f"benchmark/generators/{cell.traffic['generator']}.py")
    files += [f"benchmark/metrics/{m['name']}.py"
              for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    return sorted(set(files))


@pytest.mark.parametrize("path", _run_modules())
def test_a_run_module_loads_no_jax(path):
    code = ("import runpy, importlib; "
            f"runpy.run_path({str(ROOT / path)!r}, run_name='probe'); "
            "[importlib.import_module(m) for m in ("
            "'reconfigisp_tpu_torch.deploy',"
            " 'reconfigisp_tpu_torch.pipeline',"
            " 'reconfigisp_tpu_torch.config',"
            " 'reconfigisp_tpu_torch.supernet',"
            " 'reconfigisp_tpu_torch.search.trainer')]")
    assert not _loaded(code) & FORBIDDEN


@pytest.mark.parametrize("module", ["ops", "zoo", "serve", "search"])
def test_the_reference_loads_nothing_of_the_port(module):
    got = _loaded(f"import benchmark.reference.{module}")
    assert not got & (FORBIDDEN | {"reconfigisp_tpu_torch"})

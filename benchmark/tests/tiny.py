"""A copy of the benchmark with throwaway cells at a size the CPU holds.

`tiny_root(dst)` copies BENCHMARK.json and benchmark/ into dst and adds, by
new files and new entries only, a serving cell and a search cell of each
configuration's kind: frames of 64 x 96 tiled at 32 / 24, crops of 16 x 16
two to a batch, one sRGB slot.  They are held to the limits of the cells
they shrink: sid_serve_f32 (or sid_serve_bf16) and sid_search_native (or
sid_search_proxy).
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

TINY_FRAMES = {"generator": "mosaics", "loop": "closed", "clients": 1,
               "frames": 2, "height": 64, "width": 96, "coarse": 8,
               "cast": [0.8, 1.0, 0.6], "shot": 0.08, "read": 0.02,
               "checked_frames": 2, "profile_frames": 1}
TINY_CROPS = {"generator": "planted_pairs", "pairs": 5, "batch": 2,
              "crop": 16, "coarse": 4, "cast": [0.8, 1.0, 0.6],
              "shot": 0.08, "read": 0.02, "wb01": [0.25, 0.2, 1 / 3],
              "gamma01": 0.14116, "profile_steps": 1}


def _write(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1) + "\n")


def tiny_root(dst: Path, *, storage: str = "f32", use_proxies: bool = False,
              n_step: int = 1) -> Path:
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    b = dst / "benchmark"

    serve = json.loads((b / "configs" / "sid_isp.json").read_text())
    serve.update(patch=32, stride=24, cnn_storage=storage)
    _write(b / "configs" / "tiny_isp.json", serve)
    search = json.loads((b / "configs" / "sid_search.json").read_text())
    search["network_G"].update(n_step=n_step, use_proxies=use_proxies)
    _write(b / "configs" / "tiny_search.json", search)
    _write(b / "traffic" / "tiny_frames.json", TINY_FRAMES)
    _write(b / "traffic" / "tiny_crops.json", TINY_CROPS)

    shrunk = {"tiny_serve": f"sid_serve_{storage}",
              "tiny_search": ("sid_search_proxy" if use_proxies
                              else "sid_search_native")}
    for name, config, traffic in (
            ("tiny_serve", "tiny_isp", "tiny_frames"),
            ("tiny_search", "tiny_search", "tiny_crops")):
        limits = json.loads((b / "limits" / f"{shrunk[name]}.json")
                            .read_text())["limits"]
        bench["configs"].append({
            "name": config, "source": "https://arxiv.org/abs/2109.04760",
            "file": f"benchmark/configs/{config}.json", "reduced": [],
            "why": "a throwaway cell at a size the CPU holds"})
        bench["workloads"].append({"name": name, "config": config,
                                   "traffic": traffic, "chips": 1,
                                   "why": "a throwaway cell"})
        for metric in bench["end_to_end"] + bench["per_layer"]:
            kind = "serve" if name == "tiny_serve" else "search"
            cells = metric.get("workloads")
            if cells and any(c.startswith(f"sid_{kind}") for c in cells):
                cells.append(name)
        _write(b / "limits" / f"{name}.json", {"limits": limits})
    _write(dst / "BENCHMARK.json", bench)
    return dst

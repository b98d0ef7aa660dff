"""Serving system of a pipeline with windowed ops: systems/serve.py's, with
the windowed ops' work counted at the radii the program runs.

Set-up, window and check are serve.System's.  The window also sets the
kernel modules' launch counters of the pipeline's windowed ops to 0 when
it opens and keeps what they read when it closes (record["launches"]:
{op: launches}, nothing for a module without a counter).  The work adds
each windowed op at its radii, read from the drawn logits as the plain
reference reads them (reference/ops.radius of their sigmoid; fast-NLM's
block radius from image 0, as every image of a tile group shares the
op's parameters), and lists one application per tile of a frame, so that
the bound is the same however the program groups tiles into launches.
"""

from __future__ import annotations

import importlib

import torch

from benchmark.lib import counts
from benchmark.reference import ops as refops
from benchmark.reference import zoo
from benchmark.systems import serve
from benchmark.systems.search import BLOCK_PARAM, RADIUS_PARAM

KERNELS = "reconfigisp_tpu_torch.ops.kernels."


class System(serve.System):
    def window(self, seconds: float, trace: bool) -> dict:
        mods = {op: importlib.import_module(KERNELS + op)
                for op in zoo.parse(self.cfg["architecture"])
                if op in counts.WINDOWED}
        mods = {op: m for op, m in mods.items() if hasattr(m, "launches")}
        for m in mods.values():
            m.launches = 0
        record = super().window(seconds, trace)
        record["launches"] = {op: m.launches for op, m in mods.items()}
        return record

    def radii(self) -> dict:
        """{op: (window radius, block radius)} of the windowed ops at the
        drawn logits."""
        out = {}
        for i, op in enumerate(zoo.parse(self.cfg["architecture"])):
            if op not in RADIUS_PARAM:
                continue
            p = torch.sigmoid(self.logits[i].detach().float().cpu())
            block = (int(refops.radius(p[BLOCK_PARAM[op]]))
                     if op in BLOCK_PARAM else 0)
            out[op] = (int(refops.radius(p[RADIUS_PARAM[op]])), block)
        return out

    def work(self) -> dict:
        h, w = self.pool.shape[2:4]
        patch, stride = self.cfg["patch"], self.cfg["stride"]
        radii = self.radii()
        tiles = counts.frame_tiles(h, w, patch, stride)
        return {"flops_per_frame": counts.serve_frame_flops(
                    self.cfg["architecture"], h, w, patch, stride, radii),
                "peak_flops": counts.PEAK_FLOPS[self.storage],
                "windowed": {op: [((1, patch, patch, 3), r, block)] * tiles
                             for op, (r, block) in radii.items()}}

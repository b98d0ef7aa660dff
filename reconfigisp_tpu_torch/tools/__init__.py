"""Tools of the method's accuracy runs and of the real-scale rehearsal.

Counterparts of the repo's tools/planted_demo.py, tools/ft_divergence.py and
tools/rehearse_real_scale.py (its SID, S7 and OnePlus/YOLO legs), and
proxy_imitation.py (each proxy's held-out error against its op), each run
as `python -m reconfigisp_tpu_torch.tools.<name>`.  They run on the GPU unless
`--device cpu` is given, and write only under their own output directory.
"""

from __future__ import annotations

import subprocess
from pathlib import Path

import torch

# the checkout this package lies in: its configs/ and experiments/proxies/
REPO = Path(__file__).resolve().parents[2]
CONFIGS = REPO / "configs"


def device_record(dev: torch.device) -> dict:
    """What a results file says of the device that made it: torch's name for
    the card and nvidia-smi's name and power limit, or the CPU."""
    if dev.type != "cuda":
        return {"type": "cpu"}
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        smi = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"nvidia-smi failed: {e}"
    return {"type": "cuda", "name": torch.cuda.get_device_name(index),
            "nvidia_smi": smi, "torch": torch.__version__,
            "cuda": torch.version.cuda}

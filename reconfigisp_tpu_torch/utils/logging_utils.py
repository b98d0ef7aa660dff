"""Logging: named loggers and a scalar sink.

Counterpart of reconfigisp_tpu/utils/logging_utils.py (reference
codes/utils/util.py:76-90 and the TensorBoard scalars of train.py:226-283).
Scalars always go to <log_dir>/metrics.jsonl, and to TensorBoard when asked
for and torch.utils.tensorboard imports.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Optional


def setup_logger(name: str, log_dir: Optional[str] = None,
                 filename: Optional[str] = None,
                 level=logging.INFO, screen: bool = True) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(level)
    logger.handlers.clear()
    fmt = logging.Formatter(
        "%(asctime)s.%(msecs)03d - %(levelname)s: %(message)s",
        datefmt="%y-%m-%d %H:%M:%S")
    if log_dir and filename:
        os.makedirs(log_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(log_dir, filename + ".log"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    if screen:
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    return logger


class MetricsLogger:
    """Scalar sink: JSON lines always, TensorBoard if enabled and present."""

    def __init__(self, log_dir: Optional[str], use_tb: bool = False):
        self.jsonl = None
        self.tb = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self.jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        if use_tb and log_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self.tb = SummaryWriter(log_dir=os.path.join(log_dir, "tb"))

    def scalars(self, step: int, values: dict):
        if self.jsonl:
            rec = {"step": step, "ts": time.time()}
            rec.update({k: float(v) for k, v in values.items()})
            self.jsonl.write(json.dumps(rec) + "\n")
            self.jsonl.flush()
        if self.tb:
            for k, v in values.items():
                self.tb.add_scalar(k, float(v), step)

    def close(self):
        if self.jsonl:
            self.jsonl.close()
        if self.tb:
            self.tb.close()

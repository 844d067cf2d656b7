"""Metric logging and the run directory's layout.

Counterpart of ``councilx/utils/logging.py`` (reference
utils.py::{prepare_sub_folder, write_loss}): the train loop hands the
logger a dict of host floats at each ``log_iter``; it always appends them
to ``metrics.jsonl`` and also writes TensorBoard events when
``torch.utils.tensorboard`` imports.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


def prepare_sub_folder(output_directory: str):
    """Create images/ and checkpoints/ under the run dir -> (checkpoint
    dir, image dir)."""
    image_directory = os.path.join(output_directory, "images")
    checkpoint_directory = os.path.join(output_directory, "checkpoints")
    os.makedirs(image_directory, exist_ok=True)
    os.makedirs(checkpoint_directory, exist_ok=True)
    return checkpoint_directory, image_directory


class MetricLogger:
    """``metrics.jsonl`` (one record per write: step, wall time, metrics)
    and, where it imports, a TensorBoard ``SummaryWriter``."""

    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:     # tensorboard is not installed
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(log_dir)

    def write(self, step: int, metrics: Dict, prefix: str = "") -> None:
        clean = {f"{prefix}{k}": float(v) for k, v in metrics.items()}
        rec = {"step": int(step), "time": time.time(), **clean}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in clean.items():
                self._tb.add_scalar(k, v, step)

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()

"""Scalar logging (own copy of ``mc_nerf_tpu/utils/tensorboard.py``).

The reference wires a ``SummaryWriter`` into its loss module but never
writes a scalar (``utils/tensorboard_init.py:21``).  Here per-epoch
losses, camera errors and validation metrics are written, to TensorBoard
when ``torch.utils.tensorboard`` imports, else to ``scalars.jsonl`` in
the log directory (one JSON object a line: tag, value, step, time).
"""

from __future__ import annotations

import json
import os
import shutil
import time


class ScalarWriter:
    """SummaryWriter facade with a JSONL fallback."""

    def __init__(self, log_dir: str, delete_old: bool = False, enabled: bool = True):
        self.enabled = enabled
        self._tb = None
        self._jsonl = None
        if not enabled:
            return
        if delete_old and os.path.isdir(log_dir):
            shutil.rmtree(log_dir, ignore_errors=True)
        os.makedirs(log_dir, exist_ok=True)
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:   # no tensorboard package
            self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        else:
            self._tb = SummaryWriter(log_dir)

    def scalar(self, tag: str, value: float, step: int) -> None:
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)
        elif self._jsonl is not None:
            self._jsonl.write(json.dumps({"tag": tag, "value": float(value), "step": int(step),
                                          "t": time.time()}) + "\n")
            self._jsonl.flush()

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        if self._jsonl is not None:
            self._jsonl.close()
        self._tb = self._jsonl = None

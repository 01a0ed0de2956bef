"""Run logging: a text file, TensorBoard scalars and the console
(counterpart of ``rs_detection_tpu/utils/logger.py``)."""

from __future__ import annotations

import os
import sys
import time
import types
from typing import Dict

from .registry import HOOKS


@HOOKS.register_module()
class TextLogger:
    def __init__(self, work_dir: str):
        os.makedirs(work_dir, exist_ok=True)
        self.path = os.path.join(work_dir, "log.txt")

    def log(self, data: Dict):
        with open(self.path, "a") as f:
            f.write(",".join(f"{k}:{v}" for k, v in data.items()) + "\n")


@HOOKS.register_module()
class TensorboardLogger:
    """The numbers of each record as scalars under
    ``work_dir/tensorboard``, at the record's ``iter``; nothing where
    ``torch.utils.tensorboard`` cannot be imported. The writer is opened
    at the first record, with TensorBoard's TensorFlow-free stub (the
    ``tensorboard.compat.notf`` marker): where TensorFlow is installed,
    importing it takes seconds and pulls in jax."""

    def __init__(self, work_dir: str):
        self.log_dir = os.path.join(work_dir, "tensorboard")
        self.writer = None
        self._opened = False

    def _open(self):
        self._opened = True
        sys.modules.setdefault("tensorboard.compat.notf",
                               types.ModuleType("tensorboard.compat.notf"))
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return
        self.writer = SummaryWriter(self.log_dir)

    def log(self, data: Dict):
        if not self._opened:
            self._open()
        if self.writer is None:
            return
        step = int(data.get("iter", 0))
        for k, v in data.items():
            if isinstance(v, (int, float)) and k != "iter":
                self.writer.add_scalar(k, v, global_step=step)
        self.writer.flush()


@HOOKS.register_module()
class RunLogger:
    """The text and TensorBoard loggers, and a console line per record."""

    def __init__(self, work_dir: str, enabled=True):
        self.loggers = []
        self.enabled = enabled
        if enabled:
            self.loggers = [TextLogger(work_dir), TensorboardLogger(work_dir)]

    def log(self, data: Dict):
        if not self.enabled:
            return
        for lg in self.loggers:
            lg.log(data)
        self.print_log(data)

    @staticmethod
    def print_log(data: Dict):
        parts = []
        for k, v in data.items():
            if isinstance(v, float):
                parts.append(f"{k}={v:.4f}")
            else:
                parts.append(f"{k}={v}")
        print(f"[{time.strftime('%H:%M:%S')}] " + " ".join(parts),
              flush=True)

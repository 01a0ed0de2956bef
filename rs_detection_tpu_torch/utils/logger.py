"""Run logging: a text file and the console (counterpart of
``rs_detection_tpu/utils/logger.py``; its TensorBoard scalars come with
the training half of the runner)."""

from __future__ import annotations

import os
import time
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
class RunLogger:
    """The text logger, and a console line per record."""

    def __init__(self, work_dir: str, enabled=True):
        self.loggers = []
        self.enabled = enabled
        if enabled:
            self.loggers = [TextLogger(work_dir)]

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

"""Training logger: one JSON line per record in ``<log_dir>/metrics.jsonl``,
and TensorBoard scalars when ``torch.utils.tensorboard`` imports (copy of
pemp_tpu.utils.logger; reference: src/Utils/Utils.py:1005-1023).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np


class Logger:
    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(self.log_dir, exist_ok=True)
        self.writer = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self.writer = SummaryWriter(self.log_dir)
        except ImportError:     # tensorboard is not installed: JSON lines only
            pass
        self._jsonl = open(os.path.join(self.log_dir, "metrics.jsonl"), "a")

    def log_vars(self, name, iter, **kwargs):
        """One record ``{"tag": name, "iter": iter, "t": ..., key: value}``;
        a list value is logged as its mean, an empty one not at all."""
        rec = {"tag": name, "iter": int(iter), "t": time.time()}
        for key, value in kwargs.items():
            if isinstance(value, (list, tuple)):
                if not len(value):
                    continue
                value = float(np.mean(value))
            value = float(value)
            rec[key] = value
            if self.writer is not None:
                self.writer.add_scalar(f"{name}_{key}", value, iter)
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def log_loss(self, loss, name, iter):
        self.log_vars(name, iter, loss=float(loss))

    def close(self):
        if self.writer is not None:
            self.writer.close()
        self._jsonl.close()

"""Training metrics (counterpart of ``tweediemix_tpu/utils/logging.py``): one
JSON line per log call (``{"step": ..., "time": ..., metric: value}``) and,
where tensorboardX imports, the same scalars to TensorBoard."""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricsLogger:
    def __init__(self, log_dir: Optional[str], run_name: str = "train"):
        self.path = None
        self._tb = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self.path = os.path.join(log_dir, f"{run_name}.metrics.jsonl")
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(log_dir)
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict[str, float]):
        if self.path is None:
            return
        rec = {"step": int(step), "time": round(time.time() - self._t0, 3)}
        rec.update({k: float(v) for k, v in metrics.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, float(v), step)

    def close(self):
        if self._tb is not None:
            self._tb.close()

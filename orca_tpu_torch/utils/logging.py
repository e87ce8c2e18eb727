"""Structured metrics logging (counterpart of orca_tpu/utils/logging.py):
one JSON line per record on stdout and in <workdir>/<name>.metrics.jsonl.
On multi-process runs only process 0 writes: every trainer calls `log` on
every process, and each row would otherwise appear once per process."""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class MetricsLogger:
    def __init__(self, workdir: Optional[str] = None, name: str = "train"):
        self.path = None
        if workdir:
            os.makedirs(workdir, exist_ok=True)
            self.path = os.path.join(workdir, f"{name}.metrics.jsonl")
        self._t0 = time.time()

    def log(self, step: int, **metrics):
        from orca_tpu_torch.parallel import multihost

        if not multihost.is_primary():
            return None
        rec = {"step": step, "elapsed_s": round(time.time() - self._t0, 1)}
        rec.update(
            {k: (float(v) if hasattr(v, "__float__") else v)
             for k, v in metrics.items()}
        )
        line = json.dumps(rec)
        print(line, flush=True)
        if self.path:
            with open(self.path, "a") as f:
                f.write(line + "\n")
        return rec

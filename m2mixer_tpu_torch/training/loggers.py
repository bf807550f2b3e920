"""The run logger (the port's part of ``m2mixer_tpu/training/loggers.py``).

Versioned run directories ``<save_dir>/<name>/version_N/`` holding
``metrics.jsonl`` (one JSON object per ``log`` call: ``step``, ``t`` and the
metrics, the JAX package's keys), ``summary.json`` and ``config.json``.
TensorBoard and wandb are not ported.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

__all__ = ["ExperimentLogger"]


class ExperimentLogger:
    def __init__(self, save_dir: str, name: str, config: Optional[dict] = None):
        self.save_dir = save_dir
        self.name = name or "run"
        base = os.path.join(save_dir, self.name)
        os.makedirs(base, exist_ok=True)
        existing = [int(d.split("_")[1]) for d in os.listdir(base)
                    if d.startswith("version_") and d.split("_")[1].isdigit()]
        version = max(existing) + 1 if existing else 0
        while True:  # claim the directory atomically
            log_dir = os.path.join(base, f"version_{version}")
            try:
                os.makedirs(log_dir, exist_ok=False)
                break
            except FileExistsError:
                version += 1
        self.version = version
        self.log_dir = log_dir
        self._jsonl = open(os.path.join(self.log_dir, "metrics.jsonl"), "a")
        self.summary: Dict[str, float] = {}
        self._t0 = time.time()
        if config is not None:
            with open(os.path.join(self.log_dir, "config.json"), "w") as f:
                json.dump(config, f, indent=2, default=str)

    def log(self, metrics: Dict[str, float], step: int) -> None:
        clean = {k: float(v) for k, v in metrics.items()}
        self._jsonl.write(json.dumps({"step": step, "t": time.time() - self._t0, **clean}) + "\n")
        self._jsonl.flush()

    def set_summary(self, key: str, value) -> None:
        self.summary[key] = value
        with open(os.path.join(self.log_dir, "summary.json"), "w") as f:
            json.dump(self.summary, f, indent=2, default=str)

    def close(self) -> None:
        self._jsonl.close()

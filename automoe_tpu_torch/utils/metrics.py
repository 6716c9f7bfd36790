"""Structured metrics logging, JSONL only (port of
automoe_tpu/utils/metrics.py without TensorBoard)."""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict


class MetricsLogger:
    def __init__(self, run_dir: str):
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.run_dir / "metrics.jsonl", "a")

    def log(self, step: int, metrics: Dict[str, float], prefix: str = "") -> None:
        flat = {
            (f"{prefix}/{k}" if prefix else k): float(v)
            for k, v in metrics.items()
            if isinstance(v, (int, float)) or getattr(v, "ndim", 1) == 0
        }
        self._fh.write(json.dumps({"step": int(step), "time": time.time(), **flat}) + "\n")
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()

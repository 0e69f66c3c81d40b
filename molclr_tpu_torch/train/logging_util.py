"""Metric logging: one JSON object per line in <run_dir>/metrics.jsonl.

Port of molclr_tpu/train/logging_util.py without the TensorBoard writer."""

from __future__ import annotations

import json
import os


class MetricWriter:
    def __init__(self, run_dir: str):
        os.makedirs(run_dir, exist_ok=True)
        self._jsonl = open(os.path.join(run_dir, "metrics.jsonl"), "a")

    def record(self, payload: dict) -> None:
        self._jsonl.write(json.dumps(payload) + "\n")
        self._jsonl.flush()

    def close(self) -> None:
        self._jsonl.close()


class NullWriter:
    """Drop-in no-op MetricWriter."""

    def record(self, payload: dict) -> None:
        pass

    def close(self) -> None:
        pass

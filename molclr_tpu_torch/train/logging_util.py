"""Metric logging: one JSON object per line in <run_dir>/metrics.jsonl,
and TensorBoard scalars when asked for.

Port of molclr_tpu/train/logging_util.py. The scalar tags are the JAX
package's (the reference's SummaryWriter tags). Where
`torch.utils.tensorboard` does not import, the writer writes no events, as
the JAX package's does, and prints one line that says so.
"""

from __future__ import annotations

import json
import os


class MetricWriter:
    def __init__(self, run_dir: str, tensorboard: bool = False):
        os.makedirs(run_dir, exist_ok=True)
        self._jsonl = open(os.path.join(run_dir, "metrics.jsonl"), "a")
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                print(f"tensorboard: torch.utils.tensorboard does not "
                      f"import ({e}); writing no TensorBoard events")
            else:
                self._tb = SummaryWriter(run_dir)

    def scalars(self, step: int, **values) -> None:
        """One TensorBoard scalar per keyword at `step`; NaN is skipped."""
        if self._tb is None:
            return
        for name, v in values.items():
            if v == v:
                self._tb.add_scalar(name, float(v), step)

    def record(self, payload: dict) -> None:
        self._jsonl.write(json.dumps(payload) + "\n")
        self._jsonl.flush()

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


class NullWriter:
    """Drop-in no-op MetricWriter."""

    def scalars(self, step: int, **values) -> None:
        pass

    def record(self, payload: dict) -> None:
        pass

    def close(self) -> None:
        pass

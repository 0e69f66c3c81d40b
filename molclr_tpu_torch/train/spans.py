"""Named host ranges inside the trainers, on torch.profiler's clock.

`span(name)` is a `torch.profiler.record_function` range while a
torch.profiler records, and a shared no-op context otherwise: no CUDA
call, no synchronization, no allocation and no clock read. So the ranges
land in the same trace as the kernels, copies and runtime calls they
launch, and tracing is on exactly when the profiler is (the CLI's
--profile-dir, or a caller's own `torch.profiler.profile`).

A range is a host event. One inside a CUDA graph's body is recorded at
most once, at capture, and never on a replay: a replay's kernels fall
under the range around the replay call (`graphed.replay`). The step's
parts (`step.*`) are therefore seen in eager steps and validation only.

The ranges: `pretrain.keys` (a key window's host draws, stack, pinning
and upload), `pretrain.dispatch` (one resident step or graph replay with
its LR, reseeding, loss copy and bookkeeping), `pretrain.eager_step`,
`pretrain.validate`, `graphed.replay` (the input copies and the replay
call), `graphed.capture`, `step.take`, `step.views`, `step.encode`,
`step.loss`, `step.backward` and `step.adam`.
"""

from __future__ import annotations

import contextlib

import torch.autograd.profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A record_function range `name` while the profiler records; else
    the shared null context."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(name)
    return _OFF

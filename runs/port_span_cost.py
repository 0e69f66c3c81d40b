"""The host cost of the trainers' profiler ranges: one `span()` with no
profiler recording (the shared null context entered and left), against
an empty `with` of contextlib.nullcontext and a bare call, and one range
while torch.profiler records on the CPU. Medians of 7 loops of 200,000
(20,000 with the profiler), in ns per range.

    python3 runs/port_span_cost.py
"""

import contextlib
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _ns(fn, n: int) -> float:
    runs = []
    for _ in range(7):
        t = time.perf_counter_ns()
        fn(n)
        runs.append((time.perf_counter_ns() - t) / n)
    return statistics.median(runs)


def main() -> int:
    from torch.profiler import ProfilerActivity, profile

    from molclr_tpu_torch.train.spans import span

    def off(n):
        for _ in range(n):
            with span("pretrain.dispatch"):
                pass

    def null(n):
        ctx = contextlib.nullcontext()
        for _ in range(n):
            with ctx:
                pass

    def loop(n):
        for _ in range(n):
            pass

    out = {"span_off_ns": _ns(off, 200_000), "null_with_ns": _ns(null,
                                                                 200_000),
           "empty_loop_ns": _ns(loop, 200_000)}
    with profile(activities=[ProfilerActivity.CPU]):
        out["span_on_cpu_profiler_ns"] = _ns(off, 20_000)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

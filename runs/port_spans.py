"""A traced run of one benchmark cell with the program's profiler ranges
read: the benchmark's own `--trace 1` run (benchmark/harness.run_cell),
and around its profiled sub-window benchmark/spans.py's table (count,
total, self, idle and device time of each program range) and the
benchmark's host time per profiled step (its `Pretrainer._resident_epoch`
or `FineTuner._run_steps` range over the steps). In a pretraining cell,
after the window, benchmark/spans.py's eager-step block, which gives each
`step.*` part's device ms per step; then the ranges' cost: one empty
range's host ns with the profiler off and on, and the validation's ms
under the profiler with the ranges live and replaced by the null
context, alternated.

    python3 runs/port_spans.py --workload <cell> --seed <n> --seconds <s>
                               [--root DIR] [--out FILE]

DIR is a checkout of the repository (default: the one that holds this
script) with this version of benchmark/spans.py; its benchmark/ and
molclr_tpu_torch/ are the ones imported, so a parent and a change are
compared on one card by running the script once per checkout in one
machine's run. A checkout whose trainers have no ranges gives empty
tables. Prints the idle-by-range table and the per-layer numbers on
standard error, the result line and one JSON line of the readings on
standard output, and appends the readings to FILE."""

import argparse
import contextlib
import gc
import json
import os
import sys
import time
import traceback
from pathlib import Path

T0 = time.perf_counter()
REPEATS = 5


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def _host_range(prof, name: str) -> float | None:
    """Seconds in the benchmark's host range `name` in the profile."""
    got = [e.time_range.end - e.time_range.start for e in prof.events()
           if e.name == name and e.device_type.name == "CPU"]
    return sum(got) * 1e-6 if got else None


def install(got: dict) -> None:
    """Wrap the loops' profiled sub-window and the pretraining window so
    that `got` collects the readings."""
    from benchmark import spans
    from benchmark import trace as tracelib
    from benchmark.loops import pretrain as lp

    summarize = tracelib.summarize

    def reading(prof, marker):
        try:
            got["window"] = spans.read(prof.events(), marker)
            got["host_s"] = (_host_range(prof, "Pretrainer._resident_epoch")
                             or _host_range(prof, "FineTuner._run_steps"))
        except Exception:       # the benchmark's own reading goes on
            traceback.print_exc()
        return summarize(prof, marker)

    tracelib.summarize = reading
    pre_profiled, pre_window = lp._profiled, lp._window

    def pre(ctx, pt, epoch, orders, out):
        got["steps"] = len(orders)
        return pre_profiled(ctx, pt, epoch, orders, out)

    def window(ctx, pt, *a):
        pre_window(ctx, pt, *a)
        if ctx.trace:
            try:
                got["eager"] = spans.eager_block(ctx, pt)
                got["cost"] = range_cost(ctx, pt)
            except Exception:
                traceback.print_exc()

    lp._profiled, lp._window = pre, window


def range_cost(ctx, pt) -> dict | None:
    """Host ns of one empty range with the profiler off and on (CPU and
    CUDA activity), and the validation's ms under the profiler with the
    ranges live and with them replaced by the null context, alternated
    REPEATS times, each after a garbage collection."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark.loops.pretrain import _sync
    from molclr_tpu_torch.train import pretrain as program

    if not hasattr(program, "span"):
        return None
    dev, live = ctx.device, program.span
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)

    def ranges_ns(n=2000):
        t = time.perf_counter_ns()
        for _ in range(n):
            with live("step.take"):
                pass
        return (time.perf_counter_ns() - t) / n

    out = {"range_off_ns": ranges_ns()}
    with profile(activities=acts):
        out["range_on_ns"] = ranges_ns()
    epoch = pt.step // pt.steps_per_epoch
    runs = {"live": [], "off": []}
    off = contextlib.nullcontext()
    for _ in range(REPEATS):
        for mode in ("live", "off"):
            program.span = live if mode == "live" else (lambda *a: off)
            try:
                gc.collect()
                _sync(dev)
                with profile(activities=acts):
                    t = time.perf_counter()
                    pt.validate(epoch)
                    _sync(dev)
                    runs[mode].append(1e3 * (time.perf_counter() - t))
            finally:
                program.span = live
    out["validate_ms_profiled"] = runs
    return out


def readings(got: dict) -> dict:
    """benchmark/spans.py's readings of the run, with the benchmark's host
    ms per profiled step."""
    from benchmark import spans

    steps = got.get("steps") or 0
    out = spans.readings(got.get("window"), steps, got.get("eager"))
    if got.get("host_s") is not None and steps:
        out["host_ms_per_profiled_step"] = 1e3 * got["host_s"] / steps
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[1])
    ap.add_argument("--out", type=Path,
                    default=Path("build/port_spans.jsonl"))
    args = ap.parse_args()
    out_path = args.out.resolve()
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    os.chdir(root)
    import torch

    from benchmark import harness, spans

    if not torch.cuda.is_available():
        _log("port_spans: no CUDA device; no result")
        return 2
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    got: dict = {}
    install(got)
    result = harness.run_cell(args.workload, args.seed, args.seconds, True,
                              torch.device("cuda", 0), T0, log=_log)
    for name in ("window", "eager"):
        if got.get(name):
            _log(f"{name}:")
            for line in spans.idle_lines(got[name]):
                _log(line)
    line = {"workload": args.workload, "seed": args.seed,
            "root": str(root), "result": result,
            "readings": readings(got), "window": got.get("window"),
            "eager": got.get("eager"), "cost": got.get("cost")}
    _log(json.dumps(line["readings"]))
    _log(json.dumps(line["cost"]))
    out_path.parent.mkdir(parents=True, exist_ok=True)
    with open(out_path, "a") as f:
        f.write(json.dumps(line) + "\n")
    print(json.dumps(result))
    print(json.dumps({k: line[k] for k in ("workload", "seed", "root",
                                           "readings")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

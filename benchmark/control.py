"""The readings that set a cell's limits, on the chip at the cell's own
size: for each seed, set-up and the checked steps of the program, then
the plain reference (f32, TF32 off) and the control, the reference in
TF32, each compared with the reference as the benchmark compares the
program. One process for all seeds; no measured window.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 ...

Prints one JSON line per seed and a summary: the largest program reading
of each number, and the smallest reading of the control and of each fault
planted in the reference (half of the batch left out of the loss; the
state left unchanged, a learning rate of 0). Each side's readings are
also judged against the cell's limits (limits/<cell>.json) as a run's
are (harness.judge): "correct" per side and seed, and in the summary the
seeds on which each side came out correct, which for the control and the
faults has to be none.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import shutil  # noqa: E402
import tempfile  # noqa: E402

import torch  # noqa: E402

from benchmark import harness  # noqa: E402


def readings(workload: str, seeds: list, device, config=None,
             traffic=None) -> list:
    """One dict per seed (the program's numbers, the control's, each
    planted fault's, the f64 witness and the diagnostics) and a summary
    last; config / traffic replace the cell's files (the CPU tests shrink
    them)."""
    _, cell, config0, traffic0, limits = harness.load_cell(workload)
    config, traffic = config or config0, traffic or traffic0
    loop = importlib.import_module(f"benchmark.loops.{traffic['loop']}")
    worst_prog, least, passed = {}, {}, {}
    lines = []
    for seed in seeds:
        tmp = tempfile.mkdtemp(prefix="molclr_control_")
        ctx = harness.Context(cell=cell, config=config, traffic=traffic,
                              limits=limits, seed=seed, seconds=0.0,
                              trace=False, device=device,
                              t0=time.perf_counter(), tmp=tmp,
                              log=lambda *a: None)
        try:
            out = loop.run(ctx, control=True)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        prog = {name: value for name, value, _ in out["checks"]}
        read = {"tf32": out["control"], **out["faults"]}
        read = {f: {k: v for k, v in r.items() if isinstance(v, float)}
                for f, r in read.items()}
        for k, v in prog.items():
            worst_prog[k] = max(worst_prog.get(k, 0.0), v)
        for f, r in read.items():
            low = least.setdefault(f, {})
            for k, v in r.items():
                low[k] = min(low.get(k, math.inf), v)
        correct = {side: judge(r, limits)
                   for side, r in {"program": prog, **read}.items()}
        for side, ok in correct.items():
            passed.setdefault(side, [])
            if ok:
                passed[side].append(seed)
        lines.append({"seed": seed, "correct": correct, "program": prog,
                      "control": read,
                      "f64": out.get("f64"), "diag": out.get("diag"),
                      "worst_leaf": out.get("worst_leaf")})
        del out
        if device.type == "cuda":
            torch.cuda.empty_cache()
    lines.append({"summary": workload, "program_max": worst_prog,
                  "control_and_faults_min": least,
                  "correct_on_seeds": passed})
    return lines


def judge(readings: dict, limits: dict) -> bool:
    """A side's `correct`: its readings of the cell's numbers held to the
    cell's limits by the harness's own comparison."""
    return harness.judge({k: {"value": v, "limit": limits[k]}
                          for k, v in readings.items() if k in limits})


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for line in readings(args.workload, args.seeds,
                         torch.device("cuda", 0)):
        print(json.dumps(line, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Runs one cell: finds its configuration, traffic mix, limits and metric
readers by the names in BENCHMARK.json, hands them to the training loop
that the traffic file names, and prints the result line.

Layout (each found by name, so a new cell adds files and entries only):
  configs/<config>.json        the model configuration as run
  traffic/<traffic>.json       the mix's parameters; "loop" names
                               loops/<loop>.py, which runs it
  limits/<cell>.json           the limit of each number `correct` compares
  metrics/<metric>.py          one reader per per-layer metric: read(run)
                               returns the value or None
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import traceback
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "molclr_tpu")


@dataclasses.dataclass
class Context:
    """What a loop gets: the cell's files as loaded, the run's arguments
    and a scratch directory (removed after the run)."""
    cell: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t0: float
    tmp: str
    log: object = print


def load_cell(name: str) -> tuple[dict, dict, dict, dict, dict]:
    """(BENCHMARK.json, the cell, its configuration, its traffic, its
    limits) by the cell's name."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    limits = json.loads((HERE / "limits" / f"{name}.json").read_text())
    return bench, cell, config, traffic, limits


def cell_metrics(metrics: list, cell: str) -> list:
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def reader(name: str):
    """metrics/<name>.py's read function."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    """Top-level names in sys.modules that the benchmark must not load,
    compared whole (molclr_tpu_torch is not molclr_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def judge(checks: dict) -> bool:
    """`correct`: every number compared is finite and within its limit
    (checks: {name: {"value", "limit"}})."""
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             t0: float, config=None, traffic=None, limits=None,
             log=None) -> dict:
    """One run of cell `name` on `device`; config / traffic / limits
    replace the cell's files (the CPU tests shrink them). Returns the
    result dict (checks last)."""
    bench, cell, config0, traffic0, limits0 = load_cell(name)
    tmp = tempfile.mkdtemp(prefix="molclr_bench_")
    ctx = Context(cell=cell, config=config or config0,
                  traffic=traffic or traffic0, limits=limits or limits0,
                  seed=int(seed), seconds=float(seconds), trace=bool(trace),
                  device=device, t0=t0, tmp=tmp,
                  log=log or (lambda *a: None))
    loop = importlib.import_module(f"benchmark.loops.{ctx.traffic['loop']}")
    try:
        out = loop.run(ctx)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    checks = {k: {"value": v, "limit": lim} for k, v, lim in out["checks"]}
    correct = judge(checks)
    metrics = {}
    if trace:
        for m in cell_metrics(bench["per_layer"], name):
            value = reader(m["name"])(out["layer"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        # a quantity that cells report under names of their own (each with
        # its bound) is one reading: pretrain_mol_per_s.gcn is the loop's
        # pretrain_mol_per_s
        for m in cell_metrics(bench["end_to_end"], name):
            value = out["e2e"][m["name"].split(".")[0]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": out["device"]}
    if trace and out.get("breakdown"):
        result["breakdown"] = out["breakdown"]
    result["checks"] = checks
    return result


def main(t0: float, argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    _, cell, _, _, _ = load_cell(args.workload)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {cell['chips']} CUDA device(s) needed, {found} "
              "found; no result", file=sys.stderr)
        return 2
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"benchmark: {args.workload} seed {args.seed} on "
          f"{_power_limit()}", file=sys.stderr)
    try:
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace), torch.device("cuda", 0), t0,
                          log=lambda *a: print(*a, file=sys.stderr))
    except Exception:
        traceback.print_exc()
        return 1
    found = forbidden_modules()
    if found:
        print(f"benchmark: loaded {found}, which the benchmark may not "
              f"import; no result", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0

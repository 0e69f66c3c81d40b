"""The fine-tuning cell's epoch boundary, timed: one untraced run of a
benchmark fine-tuning cell (benchmark/harness.run_cell) with each
`FineTuner._train_epoch_stack` call timed on the host between two
synchronizes (the card is idle there: the epoch before ended in its
losses' and the validation's readbacks), split into the host stack's
upload or refill (`FineTuner._upload`, to a synchronize) and the rest
(the host packing left at the boundary); where the checkout packs the
next epoch between the launches (`_TrainPass`), also each such batch's
host ms and the rows packed ahead and late.

    python3 runs/port_repack_boundary.py --workload <cell> --seed <n>
        --seconds <s> [--root DIR] [--out FILE]

DIR is a checkout of the repository (default: the one that holds this
script), whose benchmark/ and molclr_tpu_torch/ are imported, so a parent
and a change are compared on one card by running the script once per
checkout in one machine's run. Prints the result line and one JSON line
of the readings (ms, medians and ranges over the window's epochs, from
epoch 1 on) on standard output and appends both to FILE."""

import argparse
import json
import os
import statistics
import sys
import time
from pathlib import Path

T0 = time.perf_counter()


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def _stats(ms: list) -> dict | None:
    if not ms:
        return None
    return {"median": statistics.median(ms), "min": min(ms), "max": max(ms),
            "n": len(ms)}


def install(got: dict) -> None:
    """Wrap the FineTuner's epoch boundary, its upload and (where the
    checkout has it) the pass's per-batch pack so that `got` collects
    their host ms, epoch by epoch."""
    import torch

    from molclr_tpu_torch.train import finetune as ft_lib

    tuner = ft_lib.FineTuner
    stack_call, upload = tuner._train_epoch_stack, tuner._upload
    state = {"inside": False}

    def timed_stack(self, *a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state["inside"], state["upload"] = True, 0.0
        try:
            out = stack_call(self, *a, **kw)
        finally:
            state["inside"] = False
        torch.cuda.synchronize()
        total = (time.perf_counter() - t) * 1e3
        got["epochs"].append({
            "boundary_ms": total, "upload_ms": state["upload"],
            "pack_ms": total - state["upload"],
            "packed_ahead": getattr(self, "packed_ahead", None),
            "packed_late": getattr(self, "packed_late", None)})
        return out

    def timed_upload(self, split, *a, **kw):
        t = time.perf_counter()
        out = upload(self, split, *a, **kw)
        torch.cuda.synchronize()
        if state["inside"]:
            state["upload"] += (time.perf_counter() - t) * 1e3
        return out

    tuner._train_epoch_stack, tuner._upload = timed_stack, timed_upload
    got["epochs"], got["ahead_ms"] = [], []
    train_pass = getattr(ft_lib, "_TrainPass", None)
    if train_pass is not None:
        pack = train_pass.pack

        def timed_pack(self):
            t = time.perf_counter()
            out = pack(self)
            if not state["inside"] and out:
                got["ahead_ms"].append((time.perf_counter() - t) * 1e3)
            return out

        train_pass.pack = timed_pack


def readings(got: dict) -> dict:
    window = got["epochs"][1:]
    return {"epochs": len(window),
            **{k: _stats([e[k] for e in window])
               for k in ("boundary_ms", "pack_ms", "upload_ms")},
            "ahead_ms_per_batch": _stats(got["ahead_ms"]),
            "packed_ahead": sorted({e["packed_ahead"] for e in window},
                                   key=str),
            "packed_late": sorted({e["packed_late"] for e in window},
                                  key=str)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[1])
    ap.add_argument("--out", type=Path,
                    default=Path("build/port_repack_boundary.jsonl"))
    args = ap.parse_args()
    out_path = args.out.resolve()
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    os.chdir(root)
    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        _log("port_repack_boundary: no CUDA device; no result")
        return 2
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    got: dict = {}
    install(got)
    result = harness.run_cell(args.workload, args.seed, args.seconds, False,
                              torch.device("cuda", 0), T0, log=_log)
    line = {"workload": args.workload, "seed": args.seed,
            "root": str(root), "readings": readings(got),
            "result": result}
    out_path.parent.mkdir(parents=True, exist_ok=True)
    with open(out_path, "a") as f:
        f.write(json.dumps(line) + "\n")
    print(json.dumps(result))
    print(json.dumps({k: line[k] for k in ("workload", "seed", "root",
                                           "readings")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

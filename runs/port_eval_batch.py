"""An eval batch of the fine-tuning path on the card, GIN and GCN in f32:
CUDA-event ms, the host's ms to queue it, device ms by kernel and the
host's ms by operator.

    python3 runs/port_eval_batch.py [--root DIR] [--out FILE] [--models M]

DIR is a checkout of the repository (default: the one that holds this
script); its chip_smoke.py and molclr_tpu_torch/ are the ones imported, so
two commits are compared on one card by running the script once per
checkout within one machine's session, in the order parent, change,
change, parent (e.g. the parent unpacked with `git archive <commit> | tar
-x -C build/parent`). The batch is the FineTuner's first validation batch
on the synthetic BBBP stand-in at configs/finetune.yaml's widths (batch
32, 5 layers x 300, drop 0.3 in eval mode: K4f or K5f without residuals,
T = 6 tiles), as chip_smoke.py phase 9 times it. Prints one JSON line per
model (--models: gin,gcn by default) and appends them to FILE."""

import argparse
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[1])
    ap.add_argument("--out", type=Path,
                    default=Path("build/port_eval_batch.jsonl"))
    ap.add_argument("--models", default="gin,gcn")
    args = ap.parse_args()
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from molclr_tpu_torch.train import finetune as ft_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        shared = [None]
        for gnn in args.models.split(","):
            ft = cs.finetuner(cs.finetune_cfg(tmp, gnn), dev, shared)
            batch, _, mot = ft._device_item(
                "valid", *next(iter(ft.iters["valid"])))

            def call():
                return ft_lib.predict(ft.model, batch, mot)

            events_ms = cs.time_ms(call)
            host = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(20):
                    call()
                host.append(1e3 * (time.perf_counter() - t0) / 20)
            torch.cuda.synchronize()
            prof = cs.profile_steps(lambda i: call(), steps=20)
            # the host's self time by operator, from a second profile
            with profile(activities=[ProfilerActivity.CPU]) as cpu:
                for _ in range(20):
                    call()
                torch.cuda.synchronize()
            ops = sorted(((e.key, e.self_cpu_time_total / 20 / 1e3,
                           e.count / 20) for e in cpu.key_averages()),
                         key=lambda r: -r[1])
            row = dict(card=cs.card_line(), root=str(root), model=gnn,
                       tiles=batch.nbr.shape[0] // cs.TILE,
                       events_ms=events_ms, host_ms=statistics.median(host),
                       device_ms=prof["device_ms_per_step"],
                       profiled_wall_ms=prof["wall_ms_per_step"],
                       kernels=prof["kernels"], top=prof["top"],
                       host_self_ms=sum(r[1] for r in ops),
                       host_top=[dict(name=k[:80], ms=ms, calls=c)
                                 for k, ms, c in ops[:15]])
            rows.append(row)
            print(json.dumps(row), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    with args.out.open("a") as f:
        f.write("".join(json.dumps(r) + "\n" for r in rows))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

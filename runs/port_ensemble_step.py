"""The graphed fine-tuning step of one member and of the seed ensembles on
the card, for comparing two checkouts: step ms, host ms, device ms and busy
share, the port's kernels launched per step and the device ms of the
stack / cat copies.

    python3 runs/port_ensemble_step.py [--root DIR] [--out FILE]

DIR is a checkout of the repository (default: the one that holds this
script); its chip_smoke.py and molclr_tpu_torch/ are the ones imported, so
two commits are compared on one card by running the script once per
checkout within one machine's session, in the order parent, change,
change, parent (e.g. the parent unpacked with `git archive <commit> | tar
-x -C build/parent`). The cells are chip_smoke.py phase 9b's at
configs/finetune.yaml's widths (GIN / GCN, 5 layers x 300, drop 0.3, batch
32, f32): one member (BBBP), GIN BBBP with 3 seeds (M = 3), GIN ClinTox 2
targets x 3 seeds (M = 6) and GCN BBBP with 3 seeds, each timed by the
checkout's own ft_path_speed (CUDA events at each step's end, median over
25 graphed steps after 5 warm-up steps; a torch.profiler window). Prints
one JSON line per cell and appends them to FILE."""

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

CELLS = (("gin_one", "gin", "BBBP", None, 1),
         ("gcn_one", "gcn", "BBBP", None, 1),
         ("bbbp_3_seeds", "gin", "BBBP", None, 3),
         ("clintox_2x3", "gin", "ClinTox", ["CT_TOX", "FDA_APPROVED"], 3),
         ("gcn_bbbp_3_seeds", "gcn", "BBBP", None, 3))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[1])
    ap.add_argument("--out", type=Path,
                    default=Path("build/port_ensemble_step.jsonl"))
    args = ap.parse_args()
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    t0 = time.perf_counter()
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        shared = {}
        for tag, gnn, task, targets, seeds in CELLS:
            ft = cs.finetuner(cs.finetune_cfg(tmp, gnn, task_name=task,
                                              n_seeds=seeds),
                              dev, shared, targets)
            speed = cs.ft_path_speed(ft, "resident_graphed", card, tag)
            prof = speed["profile"]
            row = dict(card=card, root=str(root), tag=tag, model=gnn,
                       members=ft.n_members, step_ms=speed["step_ms"],
                       host_ms=speed["host_ms"],
                       device_ms=speed["device_ms"],
                       device_busy_share=speed["device_busy_share"],
                       port_launches_per_step=speed[
                           "port_launches_per_step"],
                       port_ms_per_step=prof["port_ms_per_step"],
                       cat_ms_per_step=sum(
                           t["ms_per_step"] for t in prof["top"]
                           if "CatArrayBatchedCopy" in t["name"]),
                       kernels=prof["kernels"], top=prof["top"])
            rows.append(row)
            print(json.dumps(row), flush=True)
    print(f"port_ensemble_step {root}: {time.perf_counter() - t0:.1f} s",
          flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "a") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

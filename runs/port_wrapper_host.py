"""Host and device microseconds per call of the fine-tuning layer kernels'
one-layer wrappers (K4f with residuals, K4b, K5f, K5b) on the card, for
comparing two checkouts.

    python3 runs/port_wrapper_host.py [--root DIR] [--out FILE]

DIR is a checkout of the repository (default: the one that holds this
script); its chip_smoke.py and molclr_tpu_torch/ are the ones imported, so
two commits are compared on one card by running the script once per
checkout within one machine's session, in the order parent, change,
change, parent. The inputs are chip_smoke.py phase 8's (the fine-tuning
batch, T = 4 tiles of 256, D = 300, f32, features zero on padded rows).
Host us: the median of 5 of chip_smoke's host_us (the time to queue 50
calls back to back while the card runs behind); device us: the sum of the
wrapper's launches from chip_smoke's pass_profile. Prints one JSON line
per wrapper and appends them to FILE."""

import argparse
import json
import statistics
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[1])
    ap.add_argument("--out", type=Path,
                    default=Path("build/port_wrapper_host.jsonl"))
    args = ap.parse_args()
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as cs
    from molclr_tpu_torch.ops import fused_gcn as FG
    from molclr_tpu_torch.ops import fused_layer as FL

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    batch = cs.finetune_batch().to(dev)
    gen = torch.Generator().manual_seed(cs.SEED + 4)
    x, pg, pc = cs.layer_inputs(batch, torch.float32, gen)
    mask = FL.adj_diag_mask(x["adj"])
    h = x["h"] * mask
    g = (0.1 * torch.randn(h.shape, generator=gen)).to(dev) * mask
    fargs = (h, x["adj"], x["cnt"], pg["etab"], pg["w1"], pg["b1"],
             pg["w2"], pg["b2"])
    _, agg, mid = FL.fused_gine_layer_fwd(*fargs, residuals=True)
    calls = {
        "fused_gine_layer": lambda: FL.fused_gine_layer_fwd(
            *fargs, residuals=True),
        "fused_gine_layer_bwd": lambda: FL.fused_gine_layer_bwd(
            g, x["adj"], x["cnt"], agg, mid, pg["w1"], pg["w2"]),
        "fused_gcn_layer": lambda: FG.fused_gcn_layer_fwd(h, x["adj"],
                                                          pc["w"]),
        "fused_gcn_layer_bwd": lambda: FG.fused_gcn_layer_bwd(
            g, h, x["adj"], pc["w"]),
    }
    rows = []
    for name, fn in calls.items():
        host = statistics.median(cs.host_us(fn) for _ in range(5))
        device = sum(cs.pass_profile(fn).values())
        row = dict(card=card, root=str(root), name=name, host_us=host,
                   device_us=device)
        rows.append(row)
        print(json.dumps(row), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "a") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

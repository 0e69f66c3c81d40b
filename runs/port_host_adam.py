"""The Pretrainer's host-path step with the Adam it built on the card
before and the one it builds now, in one process on one card.

    python3 runs/port_host_adam.py [--rounds N] [--out FILE]
                                                  (repository root, card)

The host path (device_cache_mb 0: eager steps on batches streamed from the
host) of chip_smoke.py's full-width pretraining config (GIN f32, B = 512,
5 x 300 / 512, tile 256) on phase 7's 4,096-molecule corpus, timed by
chip_smoke.path_speed (step ms: the median gap between the CUDA events at
step ends; host ms; the profiler's device ms per step), with the two
Adams in alternating rounds, before, after, after, before, ...:
  before  torch.optim.Adam not capturable (its step counts and bias
          corrections on the host), which the Pretrainer built on the host
          path until it built one Adam on the card for every path;
  after   torch.optim.Adam capturable (step counts and LR on the card),
          which Pretrainer.setup_state builds on the card now.
One Pretrainer: its model and data are kept, the optimizer is swapped
between rounds with its moments carried over (load_optimizer_state).
Prints one JSON line per round and writes them to --out."""

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from molclr_tpu_torch.data.synthetic import \
    write_pretrain_corpus  # noqa: E402
from molclr_tpu_torch.train.optim import adam_torch, \
    load_optimizer_state  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", type=Path,
                    default=Path("chiprun_out/port_host_adam.jsonl"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("port_host_adam: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, card = torch.device("cuda", 0), cs.card_line()
    args.out.parent.mkdir(parents=True, exist_ok=True)
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        corpus = os.path.join(tmp, "pretrain.txt")
        write_pretrain_corpus(corpus, 4096, seed=0)
        pre = cs.Pretrainer(cs.pretrain_cfg(device_cache_mb=0), dev)
        pre.setup_data(cs.read_pretrain_smiles(corpus)).setup_state()
        cs.check(pre.graph_steps == 0 and all(
            g["capturable"] for g in pre.opt.param_groups),
            "the host path's Adam is not the capturable one")
        for r in range(args.rounds):
            order = (False, True) if r % 2 == 0 else (True, False)
            for capturable in order:
                opt = adam_torch(pre.model.parameters(),
                                 pre.cfg.weight_decay, capturable)
                load_optimizer_state(opt, pre.opt.state_dict())
                pre.opt = opt
                row = cs.path_speed(pre, "host", card)
                row = dict(round=r, adam="capturable" if capturable
                           else "host counts", **{k: row[k] for k in (
                               "card", "step_ms", "step_ms_mean", "host_ms",
                               "device_ms", "device_busy_share")})
                rows.append(row)
                print(json.dumps(row), flush=True)
    args.out.write_text("".join(json.dumps(r) + "\n" for r in rows))
    print(card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""chip_smoke.py's phase 18 (data parallelism and the Orbax reader)
alone, on one card.

    python3 runs/port_dp_phase.py

It builds the kernels, writes phase 7's 4,096-molecule corpus, times
phase 15's units-path GIN f32 graphed step with `path_speed` (the one-card
row that phase 18 (a) prints its DP step beside), then runs `dp_phase`:
(b) two ranks sharing the card through gloo (GIN and GCN, card against
CPU, launch counts, ranks bit-identical), (a) world 1 on NCCL through the
CLI and the units path replayed as CUDA graphs, and (c) the Orbax fixture
read and embedded. It raises on any failed check, as chip_smoke.py does.
"""

import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from molclr_tpu_torch import native  # noqa: E402
from molclr_tpu_torch.ops import _build  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("port_dp_phase: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    native.build()
    print(f"build: {_build.build_all()} {time.perf_counter() - t0:.1f} s",
          flush=True)
    log = lambda *_: None  # noqa: E731
    with tempfile.TemporaryDirectory() as tmp:
        corpus = os.path.join(tmp, "pretrain.txt")
        with open(corpus, "w") as f:
            f.write("\n".join(cs.synthetic_corpus(4096, seed=0)) + "\n")
        base = cs.Pretrainer(cs.pretrain_cfg(), dev)
        base.setup_data(cs.read_pretrain_smiles(corpus)).setup_state()
        base._activate_units(log)
        units_row = cs.path_speed(base, "resident_graphed", card)
        cs.dp_phase(tmp, card, dev, units_row)
    print(f"port_dp_phase took {time.perf_counter() - t0:.1f} s", flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

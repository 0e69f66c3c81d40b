"""chip_smoke.py's phase 19 (node-row-sharded giant-batch pretraining and
the sharded aggregations) alone, on one card.

    python3 runs/port_part_phase.py

It builds the kernels, then runs `part_phase`: (a) and (b) four ranks
sharing the card through gloo (the partitioned GIN and GCN steps against
the CPU's, launch counts, all-reduces, ranks bit-identical, an aug 'none'
step against the one-card step on the whole giant batch; edgepart's three
variants against the single-rank aggregation), (c) world 1 on NCCL
against the one-card step bit for bit. It raises on any failed check, as
chip_smoke.py does.
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
        print("port_part_phase: no CUDA device", file=sys.stderr)
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
    with tempfile.TemporaryDirectory() as tmp:
        cs.part_phase(tmp, card, dev)
    print(f"port_part_phase took {time.perf_counter() - t0:.1f} s",
          flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

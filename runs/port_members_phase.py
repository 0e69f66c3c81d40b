"""chip_smoke.py's member-axis and wide-layer kernel cases (phase 8) and its
seed-ensemble phase (9b) alone, on the card.

    python3 runs/port_members_phase.py

Builds the kernels, runs member_kernel_phase on phase 8's fine-tuning batch
and wide_kernel_phase, then ensemble_phase against one-member graphed steps
of GIN and GCN timed as phase 9 times them (ft_path_speed); prints each
phase's lines as chip_smoke.py does, and the seconds each took."""

import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from molclr_tpu_torch.ops import _build  # noqa: E402


def main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    t0 = time.perf_counter()
    print(f"build {_build.build_all()}", flush=True)
    fbatch = cs.finetune_batch().to(dev)
    t1 = time.perf_counter()
    cs.member_kernel_phase(fbatch, dev)
    t2 = time.perf_counter()
    cs.wide_kernel_phase(dev)
    t3 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        shared = {}
        one = {gnn: cs.ft_path_speed(
            cs.finetuner(cs.finetune_cfg(tmp, gnn), dev, shared),
            "resident_graphed", card, f"{gnn}_float32")
            for gnn in ("gin", "gcn")}
        t4 = time.perf_counter()
        cs.ensemble_phase(dev, tmp, card, shared, one)
    t5 = time.perf_counter()
    print(f"seconds: build {t1 - t0:.1f}, members {t2 - t1:.1f}, wide "
          f"{t3 - t2:.1f}, one-member speed {t4 - t3:.1f}, ensembles "
          f"{t5 - t4:.1f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

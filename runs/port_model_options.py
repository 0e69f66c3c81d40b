"""chip_smoke.py's phase 17 (the model options) alone, on one card.

    python3 runs/port_model_options.py

It builds the kernels, writes what the earlier phases would have left for
phase 17 (phase 3's GIN and GCN checkpoints from 1,024 synthetic SMILES,
phase 7's 4,096-molecule corpus, phase 15's units-path GIN f32 graphed
step timed with `path_speed`), then runs `model_options_phase`: the ELL
aggregations, pool max, the embed CLI at --tile 0, tile-0 and pool-max
steps, LinkFineTuneNet and the TensorBoard writer. It raises on any
failed check, as chip_smoke.py does.
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
        print("port_model_options: no CUDA device", file=sys.stderr)
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
        graphs, _ = cs.featurize_many(cs.synthetic_corpus(cs.N_MOLS,
                                                          seed=cs.SEED))
        for model_type in ("gin", "gcn"):
            cs.write_checkpoint(model_type, graphs,
                                os.path.join(tmp, f"{model_type}.pth"), dev)
        corpus = os.path.join(tmp, "pretrain.txt")
        with open(corpus, "w") as f:
            f.write("\n".join(cs.synthetic_corpus(4096, seed=0)) + "\n")
        batch, spec = cs.pretrain_batch()
        base = cs.Pretrainer(cs.pretrain_cfg(), dev)
        base.setup_data(cs.read_pretrain_smiles(corpus)).setup_state()
        base._activate_units(log)
        units_row = cs.path_speed(base, "resident_graphed", card)
        cs.model_options_phase(tmp, card, dev, batch, spec, units_row)
    print(f"port_model_options took {time.perf_counter() - t0:.1f} s",
          flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

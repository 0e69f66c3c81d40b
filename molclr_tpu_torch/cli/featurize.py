"""Corpus featurization CLI: build the memory-mapped on-disk corpus
(data/corpus.py) once, so that pretraining at PubChem-10M scale (ref
config.yaml:27) starts by mapping it instead of featurizing.

Port of molclr_tpu/cli/featurize.py, with the same output lines.

    python -m molclr_tpu_torch.cli.featurize corpus.txt corpus.mtpu
    python -m molclr_tpu_torch.cli.pretrain --data corpus.mtpu
"""

from __future__ import annotations

import argparse
import os
import time


def _smiles_stream(path: str):
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                yield line.split(",")[-1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="molclr-featurize",
        description="featurize a SMILES corpus to a memory-mapped on-disk "
                    "format (streamed; constant host memory)")
    p.add_argument("input", help="SMILES text file (one per line, or CSV "
                                 "with SMILES in the last column)")
    p.add_argument("output", help="output corpus directory")
    p.add_argument("--add-hs", action="store_true",
                   help="explicit hydrogens (required for aug='mix', "
                        "ref dataset_mix.py:88)")
    p.add_argument("--synthetic", type=int, default=0, metavar="N",
                   help="generate an N-molecule synthetic corpus at "
                        "`input` first if it does not exist")
    p.add_argument("--chunk-size", type=int, default=100_000)
    p.add_argument("--no-native", action="store_true",
                   help="use the Python featurizer")
    args = p.parse_args(argv)

    if args.synthetic and not os.path.exists(args.input):
        from molclr_tpu_torch.data.synthetic import write_pretrain_corpus

        print(f"generating synthetic corpus ({args.synthetic} "
              f"molecules) -> {args.input}")
        write_pretrain_corpus(args.input, args.synthetic, seed=0)

    from molclr_tpu_torch.data.corpus import build_corpus

    t0 = time.time()
    meta = build_corpus(_smiles_stream(args.input), args.output,
                        add_hs=args.add_hs, chunk_size=args.chunk_size,
                        prefer_native=not args.no_native, log=print)
    dt = time.time() - t0
    rate = meta["n_mols"] / max(dt, 1e-9)
    print(f"built {args.output}: {meta['n_mols']} molecules, "
          f"{meta['n_nodes']} atoms, {meta['n_edges']} directed edges "
          f"in {dt:.1f}s ({rate:,.0f} mol/s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

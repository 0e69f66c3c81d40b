"""The port's native featurizer against its Python featurizer on fuzzed
strings: random strings over a SMILES alphabet, and synthetic molecules
with one to three characters inserted or deleted.

    python3 runs/port_native_fuzz.py [--n 20000] [--seed 0]   (repository root)

Each string is featurized with and without hydrogens by
`molclr_tpu_torch.native.featurize_smiles_native` and by
`molclr_tpu_torch.data.featurize.featurize_smiles`; a case differs when one
side parses and the other does not, when an array differs, or when the
Python side raises. Prints up to 20 differing cases and one JSON line
{"cases": N, "differing": D}; exits 1 if D > 0. Runs on the CPU."""

import argparse
import json
import random
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from molclr_tpu_torch import native  # noqa: E402
from molclr_tpu_torch.data.featurize import featurize_smiles  # noqa: E402
from molclr_tpu_torch.data.synthetic import synthetic_corpus  # noqa: E402

ALPHABET = list("CNOScn()=#-:/\\12%.[]@H+") + [
    "Cl", "Br", "[nH]", "[C@@H]", "c1", "C1", "=O"]
FIELDS = ("atom_type", "chirality", "edge_src", "edge_dst", "bond_type",
          "bond_dir")


def same(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    return all(np.array_equal(getattr(a, f), getattr(b, f)) for f in FIELDS)


def cases(n: int, seed: int):
    rng = random.Random(seed)
    base = synthetic_corpus(300, seed=seed + 1)
    for k in range(n):
        if k % 2:
            yield "".join(rng.choice(ALPHABET)
                          for _ in range(rng.randint(1, 14)))
            continue
        chars = list(rng.choice(base))
        for _ in range(rng.randint(1, 3)):
            pos = rng.randint(0, len(chars))
            if rng.random() < 0.5:
                chars.insert(pos, rng.choice(ALPHABET))
            elif chars:
                chars.pop(min(pos, len(chars) - 1))
        yield "".join(chars)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=20_000)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    total = differing = 0
    for s in cases(args.n, args.seed):
        for add_hs in (False, True):
            total += 1
            try:
                want = featurize_smiles(s, add_hs)
            except Exception as e:  # a crash of the reference is a case
                want = e
            got = native.featurize_smiles_native(s, add_hs)
            if isinstance(want, Exception) or not same(got, want):
                differing += 1
                if differing <= 20:
                    print(f"differs: {s!r} add_hs={add_hs} native "
                          f"{'parses' if got is not None else 'refuses'}, "
                          f"Python {want!r:.60}")
    print(json.dumps({"cases": total, "differing": differing}))
    return 1 if differing else 0


if __name__ == "__main__":
    sys.exit(main())

"""Deterministic synthetic SMILES corpora (copied from molclr_tpu.data.
synthetic: random_smiles, synthetic_corpus and write_pretrain_corpus; the
task-label helpers come with fine-tuning).

Generated molecules are template scaffolds with substituent slots; every
emitted SMILES is validated by the in-repo parser, and a seed gives the
same corpus as the JAX package's synthetic_corpus.
"""

from __future__ import annotations

import os

import numpy as np

from molclr_tpu_torch.chem.smiles import parse_smiles

_SCAFFOLDS = [
    "c1ccccc1{a}",
    "c1ccc(cc1{a}){b}",
    "c1ccncc1{a}",
    "c1cnccc1{a}",
    "C1CCCCC1{a}",
    "C1CCNCC1{a}",
    "c1ccsc1{a}",
    "c1ccoc1{a}",
    "c1cc[nH]c1{a}",
    "c1ccc2ccccc2c1{a}",
    "C1CCCC1{a}",
    "{a}CC{b}",
    "{a}CCC{b}",
    "{a}CCCC{b}",
    "{a}CC(C){b}",
    "{a}C(=O)N{b}",
    "{a}C(=O)O{b}",
    "{a}CCOC{b}",
    "{a}CCN(C){b}",
    "{a}CCS{b}",
    "c1ccc(cc1)C{a}",
    "c1ccc(cc1)CC(=O)N{a}",
    "c1ccc(cc1)S(=O)(=O)N{a}",
    "C1CCC(CC1)N{a}",
    "c1ccc(cc1)OC{a}",
]

_SUBSTITUENTS = [
    "", "C", "CC", "CCC", "C(C)C", "O", "OC", "N", "NC", "F", "Cl", "Br",
    "C#N", "C(=O)O", "C(=O)OC", "C(=O)N", "CO", "CN", "C(F)(F)F", "S",
    "SC", "CCO", "CCN", "c8ccccc8", "Cc8ccccc8", "OCc8ccccc8",
    "c8ccncc8", "N(C)C", "CC=C", "C(=O)C",
]


def random_smiles(rng: np.random.RandomState, max_tries: int = 20) -> str:
    for _ in range(max_tries):
        tpl = _SCAFFOLDS[rng.randint(len(_SCAFFOLDS))]
        s = tpl
        for slot in ("{a}", "{b}"):
            if slot in s:
                sub = _SUBSTITUENTS[rng.randint(len(_SUBSTITUENTS))]
                if s.startswith(slot) and sub:
                    s = s.replace(slot, sub, 1)
                else:
                    s = s.replace(slot, f"({sub})" if sub else "", 1)
        if parse_smiles(s, strict=False) is not None:
            return s
    return "CCO"


def synthetic_corpus(n: int, seed: int = 0) -> list[str]:
    rng = np.random.RandomState(seed)
    return [random_smiles(rng) for _ in range(n)]



def write_pretrain_corpus(path: str, n: int, seed: int = 0) -> None:
    """One SMILES per line (the reference reads the last CSV column of each
    row, ref dataset/dataset.py:46-53; plain lines are compatible)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for s in synthetic_corpus(n, seed):
            f.write(s + "\n")

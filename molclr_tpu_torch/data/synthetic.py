"""Deterministic synthetic SMILES corpora and tasks (copied from
molclr_tpu.data.synthetic).

Generated molecules are template scaffolds with substituent slots; every
emitted SMILES is validated by the in-repo parser, and a seed gives the
same corpus as the JAX package's synthetic_corpus.
"""

from __future__ import annotations

import csv
import os

import numpy as np

from molclr_tpu_torch.chem.mol import Mol
from molclr_tpu_torch.chem.smiles import parse_smiles
from molclr_tpu_torch.data.tasks import TaskSpec

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


def synthetic_property(mol: Mol) -> float:
    """A logP-like composition score — the regression target."""
    z = [a.atomic_num for a in mol.atoms]
    n_c = sum(1 for x in z if x == 6)
    n_o = sum(1 for x in z if x == 8)
    n_n = sum(1 for x in z if x == 7)
    n_hal = sum(1 for x in z if x in (9, 17, 35, 53))
    n_arom = sum(1 for a in mol.atoms if a.is_aromatic)
    n_ring_bonds = sum(mol.ring_bond_flags())
    return (0.25 * n_c - 0.6 * n_o - 0.45 * n_n + 0.3 * n_hal
            + 0.12 * n_arom + 0.05 * n_ring_bonds)


def synthetic_label(mol: Mol, target_idx: int = 0) -> int:
    """Classification target: structural predicates cycled by target index."""
    z = [a.atomic_num for a in mol.atoms]
    # substituent-driven predicates first: they vary WITHIN scaffold groups,
    # so scaffold-split valid/test sets stay class-balanced
    preds = [
        any(x in (9, 17, 35, 53) for x in z) or sum(
            1 for x in z if x == 8) >= 2,
        sum(1 for x in z if x == 8) >= 2,
        any(a.atomic_num == 7 and a.is_aromatic for a in mol.atoms),
        sum(mol.ring_bond_flags()) >= 6,
        sum(1 for x in z if x == 16) >= 1,
    ]
    return int(preds[target_idx % len(preds)])


def write_pretrain_corpus(path: str, n: int, seed: int = 0) -> None:
    """One SMILES per line (the reference reads the last CSV column of each
    row, ref dataset/dataset.py:46-53; plain lines are compatible)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for s in synthetic_corpus(n, seed):
            f.write(s + "\n")


def write_task_csv(path: str, spec: TaskSpec, n: int, seed: int = 0,
                   label_noise: float = 0.0,
                   pathologies: bool = False) -> None:
    """MoleculeNet-format CSV: a 'smiles' column plus one column per target
    (ref dataset/dataset_test.py:94-111 reads by DictReader).

    Every fabricated CSV carries a `_synthetic` marker column: the
    fine-tune loader sniffs it and stamps all reported results
    synthetic=true even when the file pre-exists on disk, so fabricated
    data can never silently masquerade as MoleculeNet numbers.

    pathologies=True fabricates the REAL datasets' messiness on the
    exact schema (the 13-task dress rehearsal): extra DeepChem-style
    metadata columns (mol_id, name), a per-target ~8% of EMPTY labels
    with a different missing pattern per column (exercising the
    row-set-mismatch fallback from the vmapped multi-target program to
    the reference's sequential per-target loop), and ~2% unparseable
    SMILES rows (the reference drops them, dataset_test.py:102-104)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    rng = np.random.RandomState(seed)
    rows = []
    bad_smiles = ["C1CC", "[Zz]", "C==C", "(("]
    for i, s in enumerate(synthetic_corpus(n, seed)):
        mol = parse_smiles(s, strict=False)
        if mol is None:
            continue
        row = {"smiles": s, "_synthetic": "true"}
        if pathologies:
            row["mol_id"] = f"SYN-{i:06d}"
            row["name"] = f"synthetic-{i}"
        for ti, tgt in enumerate(spec.targets):
            # real multi-task CLASSIFICATION sets (Tox21/SIDER/MUV/
            # ClinTox) carry per-column missing labels; the regression
            # sets (ESOL/FreeSolv/Lipo/qm7-9) are fully labeled — so the
            # rehearsal exercises BOTH the sequential fallback and the
            # coinciding-rows vmapped multi-target program
            if (pathologies and spec.task == "classification"
                    and len(rows) > 0 and rng.rand() < 0.08):
                row[tgt] = ""          # missing label for THIS column
                continue
            if spec.task == "classification":
                y = synthetic_label(mol, ti)
                if label_noise and rng.rand() < label_noise:
                    y = 1 - y
                row[tgt] = y
            else:
                row[tgt] = round(
                    synthetic_property(mol) + 0.05 * ti
                    + (rng.randn() * label_noise if label_noise else 0.0), 4)
        rows.append(row)
        if pathologies and rng.rand() < 0.02:
            bad = {"smiles": bad_smiles[i % len(bad_smiles)],
                   "_synthetic": "true", "mol_id": f"BAD-{i:06d}",
                   "name": "unparseable"}
            for ti, tgt in enumerate(spec.targets):
                bad[tgt] = 0 if spec.task == "classification" else 0.0
            rows.append(bad)
    cols = ["smiles", "_synthetic", *spec.targets]
    if pathologies:
        cols = ["mol_id", "name", "smiles", "_synthetic", *spec.targets]
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=cols)
        writer.writeheader()
        writer.writerows(rows)

"""Dataset splits: Murcko scaffold split (reference semantics) and random
split.

Scaffold split reproduces ref dataset/dataset_test.py:42-91: group molecules
by scaffold key, sort groups by (size, first index) descending, then greedily
assign whole groups to train until the train cutoff would be exceeded, then
to valid until the valid cutoff would be exceeded, else test.

Random split: the reference's version has overlapping valid/test sets
(quirk Q4, dataset_test.py:203: `test_idx = indices[:split+split2]` includes
the validation rows). The default here is the corrected disjoint split;
quirk_compat=True reproduces the reference behavior for comparison runs.

Copied from molclr_tpu/data/splits.py with its imports
rewritten to this package.
"""

from __future__ import annotations

import numpy as np

from molclr_tpu_torch.chem.scaffold import murcko_scaffold_smiles
from molclr_tpu_torch.chem.smiles import parse_smiles


def generate_scaffold(smiles: str) -> str:
    mol = parse_smiles(smiles, strict=False)
    if mol is None:
        return ""
    return murcko_scaffold_smiles(mol)


def scaffold_split(smiles_list: list[str], valid_size: float = 0.1,
                   test_size: float = 0.1, keys: list[str] | None = None):
    """`keys`: optional precomputed scaffold keys aligned with
    smiles_list (multi-target tasks compute them once per molecule and
    reuse across target columns)."""
    scaffolds: dict[str, list[int]] = {}
    for idx, s in enumerate(smiles_list):
        k = keys[idx] if keys is not None else generate_scaffold(s)
        scaffolds.setdefault(k, []).append(idx)
    scaffold_sets = [
        sorted(v) for v in sorted(
            scaffolds.values(), key=lambda v: (len(v), v[0]), reverse=True)
    ]

    n = len(smiles_list)
    train_cutoff = (1.0 - valid_size - test_size) * n
    valid_cutoff = (1.0 - test_size) * n
    train, valid, test = [], [], []
    for group in scaffold_sets:
        if len(train) + len(group) > train_cutoff:
            if len(train) + len(valid) + len(group) > valid_cutoff:
                test.extend(group)
            else:
                valid.extend(group)
        else:
            train.extend(group)
    return train, valid, test


def random_split(n: int, valid_size: float = 0.1, test_size: float = 0.1,
                 seed: int = 0, quirk_compat: bool = False):
    rng = np.random.RandomState(seed)
    indices = rng.permutation(n)
    split = int(np.floor(valid_size * n))
    split2 = int(np.floor(test_size * n))
    valid = indices[:split].tolist()
    if quirk_compat:
        test = indices[: split + split2].tolist()      # ref overlap (Q4)
        train = indices[split + split2:].tolist()
    else:
        test = indices[split : split + split2].tolist()
        train = indices[split + split2:].tolist()
    return train, valid, test

"""Murcko scaffold extraction for scaffold splitting.

Clean-room replacement for rdkit MurckoScaffoldSmiles as used by the reference
split (dataset/dataset_test.py:42-46). The scaffold is the union of ring
systems plus acyclic linker paths connecting them, with exocyclic/exolinker
multiple-bonded terminal atoms retained (Bemis & Murcko 1996 semantics).
Ring-free molecules yield the empty scaffold "", matching the reference's
grouping key for acyclic molecules.

Copied from molclr_tpu/chem/scaffold.py with its imports
rewritten to this package.
"""

from __future__ import annotations

from molclr_tpu_torch.chem.canon import canonical_smiles
from molclr_tpu_torch.chem.mol import BondType, Mol


def murcko_scaffold(mol: Mol) -> Mol:
    n = mol.num_atoms
    ring_atom = mol.ring_atom_flags()
    if not any(ring_atom):
        return Mol()

    adj = mol.adjacency()
    keep = list(ring_atom)

    # Linkers: atoms on simple paths between two ring atoms = atoms that are
    # not leaves of the "iteratively pruned" graph. Iteratively strip non-ring
    # atoms of (current) degree <= 1.
    alive = [True] * n
    changed = True
    while changed:
        changed = False
        for i in range(n):
            if not alive[i] or ring_atom[i]:
                continue
            deg = sum(1 for v, _ in adj[i] if alive[v])
            if deg <= 1:
                alive[i] = False
                changed = True
    for i in range(n):
        keep[i] = keep[i] or alive[i]

    # Retain atoms double/triple-bonded to a kept atom (e.g. exocyclic =O).
    extra = set()
    for b in mol.bonds:
        if b.bond_type in (BondType.DOUBLE, BondType.TRIPLE):
            if keep[b.a1] and not keep[b.a2]:
                extra.add(b.a2)
            elif keep[b.a2] and not keep[b.a1]:
                extra.add(b.a1)
    for i in extra:
        keep[i] = True

    kept_ids = [i for i in range(n) if keep[i]]
    return mol.extract_atoms(kept_ids)


def murcko_scaffold_smiles(mol: Mol) -> str:
    """Canonical scaffold key; "" for ring-free molecules."""
    scaf = murcko_scaffold(mol)
    if scaf.num_atoms == 0:
        return ""
    return canonical_smiles(scaf)

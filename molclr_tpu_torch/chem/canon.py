"""Canonical atom ranking and canonical SMILES writing.

Clean-room replacement for Chem.MolToSmiles (ref utils/clique.py:133-134) and
the canonicalization implicit in MurckoScaffoldSmiles (ref
dataset/dataset_test.py:42-46). Canonicality contract: the same molecular graph
parsed from different SMILES spellings yields the same output string. RDKit
string equality is NOT a goal — the framework only needs internally-consistent
keys for scaffold grouping and motif vocabularies.

Algorithm: Morgan-style iterative invariant refinement seeded with
(Z, aromatic, charge, degree, total-H, in-ring), ties broken by doubling ranks
on one member of the smallest tied class (tied atoms after refinement are
near-always automorphic, so the choice does not affect the output string).
Stereochemistry (chirality, bond dirs) is intentionally dropped — vocab and
scaffold keys in the reference pipeline do not depend on it.

Copied from molclr_tpu/chem/canon.py with its imports
rewritten to this package.
"""

from __future__ import annotations

from molclr_tpu_torch.chem.mol import BondType, Mol
from molclr_tpu_torch.chem.periodic import ORGANIC_SUBSET


def canonical_ranks(mol: Mol) -> list[int]:
    n = mol.num_atoms
    if n == 0:
        return []
    adj = mol.adjacency()
    ring_atom = mol.ring_atom_flags()

    invariants = []
    for i, a in enumerate(mol.atoms):
        invariants.append((
            a.atomic_num,
            int(a.is_aromatic),
            a.formal_charge,
            len(adj[i]),
            mol.total_hs(i) if a.atomic_num != 1 else 0,
            int(ring_atom[i]),
        ))
    ranks = _ranks_from_keys(invariants)

    def refine(r: list[int]) -> list[int]:
        while True:
            keys = [
                (r[i], tuple(sorted(r[v] for v, _ in adj[i])))
                for i in range(n)
            ]
            nr = _ranks_from_keys(keys)
            if nr == r:
                return nr
            r = nr

    ranks = refine(ranks)
    # Tie-breaking until all ranks are unique.
    while len(set(ranks)) < n:
        counts: dict[int, list[int]] = {}
        for i, r in enumerate(ranks):
            counts.setdefault(r, []).append(i)
        tied = min((v for v in counts.values() if len(v) > 1),
                   key=lambda v: ranks[v[0]])
        chosen = tied[0]
        keys2 = [(r * 2 + (0 if i == chosen else 1)) for i, r in enumerate(ranks)]
        ranks = refine(_ranks_from_keys(keys2))
    return ranks


def _ranks_from_keys(keys: list) -> list[int]:
    order = sorted(set(keys))
    table = {k: r for r, k in enumerate(order)}
    return [table[k] for k in keys]


_BOND_SYMBOL = {
    BondType.SINGLE: "",
    BondType.DOUBLE: "=",
    BondType.TRIPLE: "#",
    BondType.AROMATIC: "",
}


def canonical_smiles(mol: Mol) -> str:
    """Canonical (stereo-free) SMILES of all fragments, dot-joined with
    fragments ordered by their own strings."""
    n = mol.num_atoms
    if n == 0:
        return ""
    ranks = canonical_ranks(mol)
    adj = mol.adjacency()

    visited = [False] * n
    frags: list[str] = []
    # Component roots: lowest-rank atom of each component.
    comp_of = [-1] * n
    comps: list[list[int]] = []
    for i in range(n):
        if comp_of[i] != -1:
            continue
        comp = [i]
        comp_of[i] = len(comps)
        stack = [i]
        while stack:
            u = stack.pop()
            for v, _ in adj[u]:
                if comp_of[v] == -1:
                    comp_of[v] = len(comps)
                    comp.append(v)
                    stack.append(v)
        comps.append(comp)

    for comp in comps:
        root = min(comp, key=lambda i: ranks[i])
        frags.append(_write_fragment(mol, root, ranks, adj, visited))
    return ".".join(sorted(frags))


def _write_fragment(mol: Mol, root: int, ranks: list[int], adj, visited) -> str:
    # Identify ring-closure (back) edges via DFS in rank order.
    parent_bond: dict[int, int] = {}
    order: list[int] = []
    closure_bonds: set[int] = set()
    seen_bond: set[int] = set()
    stack = [root]
    visited[root] = True
    while stack:
        u = stack.pop()
        order.append(u)
        for v, bi in sorted(adj[u], key=lambda t: -ranks[t[0]]):
            if bi in seen_bond:
                continue
            if not visited[v]:
                visited[v] = True
                seen_bond.add(bi)
                parent_bond[v] = bi
                stack.append(v)
            else:
                seen_bond.add(bi)
                closure_bonds.add(bi)

    closure_at: dict[int, list[tuple[int, int]]] = {}  # atom -> [(digit, bond)]
    children: dict[int, list[tuple[int, int]]] = {}
    for v, bi in parent_bond.items():
        b = mol.bonds[bi]
        u = b.other(v)
        children.setdefault(u, []).append((v, bi))
    for u in children:
        children[u].sort(key=lambda t: ranks[t[0]])

    out: list[str] = []

    def emit_atom(i: int) -> str:
        a = mol.atoms[i]
        tok = a.symbol.lower() if a.is_aromatic else a.symbol
        needs_bracket = (
            a.atomic_num == 0
            or a.symbol not in ORGANIC_SUBSET
            or a.formal_charge != 0
            or a.isotope != 0
            or (a.explicit_hs is not None and a.atomic_num == 1)
        )
        if not needs_bracket and a.explicit_hs is not None:
            # Bracket when the stored H count would not round-trip through the
            # valence model (e.g. [CH2] radicals, [nH]).
            if a.explicit_hs != mol.valence_model_hs(i):
                needs_bracket = True
        if not needs_bracket:
            return tok
        h = a.explicit_hs if a.explicit_hs is not None else mol.implicit_hs(i)
        if a.atomic_num == 0:
            tok = "*"
        parts = ["["]
        if a.isotope:
            parts.append(str(a.isotope))
        parts.append(tok)
        if h == 1:
            parts.append("H")
        elif h > 1:
            parts.append(f"H{h}")
        if a.formal_charge > 0:
            parts.append("+" if a.formal_charge == 1 else f"+{a.formal_charge}")
        elif a.formal_charge < 0:
            parts.append("-" if a.formal_charge == -1 else f"-{-a.formal_charge}")
        parts.append("]")
        return "".join(parts)

    def bond_symbol(bi: int, a1: int, a2: int) -> str:
        bt = mol.bonds[bi].bond_type
        if bt == BondType.SINGLE:
            # Explicit '-' needed between two aromatic atoms joined by a
            # true single bond (e.g. biphenyl).
            if mol.atoms[a1].is_aromatic and mol.atoms[a2].is_aromatic:
                return "-"
            return ""
        if bt == BondType.AROMATIC:
            return ""
        return _BOND_SYMBOL[bt]

    def walk(i: int) -> None:
        out.append(emit_atom(i))
        for d, bi in closure_at.get(i, []):
            b = mol.bonds[bi]
            # bond symbol on first mention only
            first = (i == min(b.a1, b.a2, key=lambda x: pos[x]))
            if first:
                out.append(bond_symbol(bi, b.a1, b.a2))
            out.append(str(d) if d < 10 else f"%{d:02d}")
        kids = children.get(i, [])
        for k, (v, bi) in enumerate(kids):
            last = k == len(kids) - 1
            if not last:
                out.append("(")
            out.append(bond_symbol(bi, i, v))
            walk(v)
            if not last:
                out.append(")")

    # positions in DFS pre-order; closure digits are assigned in canonical
    # output order (first-appearance of the bond during the walk), so the
    # string is independent of input bond ordering.
    pos = {}

    def preorder(i: int, counter: list[int]) -> None:
        pos[i] = counter[0]
        counter[0] += 1
        for v, _ in children.get(i, []):
            preorder(v, counter)

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        preorder(root, [0])
        ordered = sorted(
            closure_bonds,
            key=lambda bi: (
                min(pos[mol.bonds[bi].a1], pos[mol.bonds[bi].a2]),
                max(pos[mol.bonds[bi].a1], pos[mol.bonds[bi].a2]),
            ),
        )
        for digit0, bi in enumerate(ordered):
            b = mol.bonds[bi]
            closure_at.setdefault(b.a1, []).append((digit0 + 1, bi))
            closure_at.setdefault(b.a2, []).append((digit0 + 1, bi))
        for lst in closure_at.values():
            lst.sort()
        walk(root)
    finally:
        sys.setrecursionlimit(old_limit)
    return "".join(out)

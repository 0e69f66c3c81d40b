"""The reference's own reading of a generated molecule, and the same
reading of a molecule slot of a packed batch, so that the two can be
compared atom for atom and bond for bond.

`parse` reads the SMILES that benchmark/traffic/molgen.py writes (atoms
C N O S F Cl Br, aromatic c n o s [nH], bonds = and #, branches, one-digit
ring closures) with MolCLR's featurization rules: atom type = atomic
number - 1, no chirality and no bond direction (the strings carry no
stereo marks), bond types single / double / triple / aromatic (a bond
between two aromatic atoms is aromatic inside a ring and single where it
joins two ring systems, as in biphenyl), and with hydrogens each heavy
atom's implicit hydrogens (aliphatic atoms fill their lowest default
valence; aromatic c holds one hydrogen with two heavy neighbours, [nH]
one, n o s none).

Both sides give a molecule as (atoms, bonds, hydrogens): the heavy atoms'
(type, chirality) in order, the sorted undirected heavy bonds (i, j,
type, direction) with i < j, and each heavy atom's hydrogen count.
"""

from __future__ import annotations

import numpy as np

SINGLE, DOUBLE, TRIPLE, AROMATIC = 0, 1, 2, 3
_Z = {"C": 6, "N": 7, "O": 8, "S": 16, "F": 9, "Cl": 17, "Br": 35,
      "c": 6, "n": 7, "o": 8, "s": 16, "[nH]": 7}
_VALENCES = {6: (4,), 7: (3,), 8: (2,), 16: (2, 4, 6), 9: (1,), 17: (1,),
             35: (1,)}
_ORDER = {SINGLE: 1, DOUBLE: 2, TRIPLE: 3}


def _tokens(smiles: str):
    i = 0
    while i < len(smiles):
        for tok in ("[nH]", "Cl", "Br"):
            if smiles.startswith(tok, i):
                break
        else:
            tok = smiles[i]
        yield tok
        i += len(tok)


def _in_ring(n: int, bonds: list, k: int) -> bool:
    """Whether bond k lies on a cycle: its ends stay joined without it."""
    a, b = bonds[k][0], bonds[k][1]
    adj = [[] for _ in range(n)]
    for m, (u, v, _) in enumerate(bonds):
        if m != k:
            adj[u].append(v)
            adj[v].append(u)
    seen, todo = {a}, [a]
    while todo:
        for v in adj[todo.pop()]:
            if v == b:
                return True
            if v not in seen:
                seen.add(v)
                todo.append(v)
    return False


def parse(smiles: str) -> tuple:
    """(atoms, bonds, hydrogens) of one generated SMILES string."""
    atoms, bonds = [], []               # atoms: (token); bonds: (i, j, sym)
    stack, rings = [], {}
    prev, pending = None, None
    for tok in _tokens(smiles):
        if tok in _Z:
            atoms.append(tok)
            if prev is not None:
                bonds.append((prev, len(atoms) - 1, pending))
            prev, pending = len(atoms) - 1, None
        elif tok == "(":
            stack.append(prev)
        elif tok == ")":
            prev = stack.pop()
        elif tok in "=#":
            pending = tok
        elif tok.isdigit():
            if tok in rings:
                bonds.append((rings.pop(tok), prev, pending))
                pending = None
            else:
                rings[tok] = prev
        else:
            raise ValueError(f"{smiles!r}: token {tok!r} is not in the "
                             "generator's grammar")
    if stack or rings:
        raise ValueError(f"{smiles!r}: unclosed branch or ring")
    arom = [t[0].islower() or t == "[nH]" for t in atoms]
    typed = []
    for k, (a, b, sym) in enumerate(bonds):
        if sym == "=":
            t = DOUBLE
        elif sym == "#":
            t = TRIPLE
        elif arom[a] and arom[b] and _in_ring(len(atoms), bonds, k):
            t = AROMATIC
        else:
            t = SINGLE
        typed.append((min(a, b), max(a, b), t))
    heavy = tuple((_Z[t] - 1, 0) for t in atoms)
    hyd = []
    for i, tok in enumerate(atoms):
        mine = [t for a, b, t in typed if i in (a, b)]
        if tok == "[nH]":
            hyd.append(1)
        elif arom[i]:
            hyd.append(1 if tok == "c" and len(mine) == 2 else 0)
        else:
            used = sum(_ORDER[t] for t in mine)
            v = next((v for v in _VALENCES[_Z[tok]] if v >= used), used)
            hyd.append(v - used)
    return (heavy, tuple(sorted((a, b, t, 0) for a, b, t in typed)),
            tuple(hyd))


def batch_molecules(b: dict, g_total: int) -> list:
    """(atoms, bonds, hydrogens) of each molecule slot of a packed batch
    (reference/data.py layout), its heavy atoms numbered in batch order;
    None for an empty slot. A slot whose bonds are not each stored both
    ways, or leave the molecule, join two hydrogens or an atom to itself,
    or give a hydrogen other than one heavy neighbour, reads hydrogens
    (-1,), which no molecule has."""
    nm = b["node_mask"].numpy().astype(bool)
    at = b["atom_type"].numpy()
    ch = b["chirality"].numpy()
    ng = b["node_graph"].numpy()
    em = b["edge_mask"].numpy().astype(bool)
    rows = zip(b["src"].numpy()[em].tolist(), b["dst"].numpy()[em].tolist(),
               b["bond_type"].numpy()[em].tolist(),
               b["bond_dir"].numpy()[em].tolist())
    by_graph, edges = {}, {}
    for v in np.flatnonzero(nm).tolist():
        by_graph.setdefault(int(ng[v]), []).append(v)
    for s, d, t, r in rows:
        edges.setdefault(int(ng[s]), []).append((s, d, t, r))
    out = [None] * g_total
    for g, vs in by_graph.items():
        heavy = [v for v in vs if at[v] > 0]
        local = {v: i for i, v in enumerate(heavy)}
        mine = set(vs)
        directed = sorted(edges.get(g, []))
        flipped = sorted((d, s, t, r) for s, d, t, r in directed)
        hyd = [0] * len(heavy)
        h_deg = {v: 0 for v in vs if at[v] == 0}
        sound = directed == flipped
        pairs = []
        for s, d, t, r in directed:
            if d not in mine or s == d or (s in h_deg and d in h_deg):
                sound = False
            elif s in local and d in local:
                if local[s] < local[d]:
                    pairs.append((local[s], local[d], t, r))
            elif s in local:
                hyd[local[s]] += 1
                h_deg[d] += 1
        sound = sound and all(n == 1 for n in h_deg.values())
        out[g] = (tuple((int(at[v]), int(ch[v])) for v in heavy),
                  tuple(sorted(pairs)), tuple(hyd) if sound else (-1,))
    return out


def expected(smiles: str, hydrogens: bool) -> tuple:
    """parse(smiles) as a batch holds it: without added hydrogens every
    heavy atom's count is 0."""
    atoms, bonds, hyd = parse(smiles)
    return atoms, bonds, hyd if hydrogens else (0,) * len(hyd)

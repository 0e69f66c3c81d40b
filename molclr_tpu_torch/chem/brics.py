"""BRICS bond cleavage and motif (clique) decomposition.

Clean-room replacement for rdkit.Chem.BRICS.FindBRICSBonds plus the fork's
clique algorithm (ref utils/clique.py:11-90). The decomposition control
flow follows the reference exactly.

The default cleavage rule set is the EXACT 16-environment BRICS table of
Degen et al. (ChemMedChem 2008, "On the Art of Compiling and Using 'Drug-
Like' Chemical Fragment Spaces") as implemented by RDKit's BRICS module:
each environment L1..L16 is an atom predicate (transcribed from the
published SMARTS into explicit graph tests below), and a bond is cleavable
iff it is an acyclic single bond whose ends match one of the published
environment pairs (acyclic double for the L7-L7 olefin rule). The round-1
7-rule approximation remains available as find_brics_bonds(rules='approx')
for vocabulary compatibility with round-1 checkpoints.

Copied from molclr_tpu/chem/brics.py with its imports
rewritten to this package.
"""

from __future__ import annotations

from molclr_tpu_torch.chem.canon import canonical_smiles
from molclr_tpu_torch.chem.mol import BondType, Mol


def _env_flags(mol: Mol):
    """Per-atom chemical-environment predicates used by the cut rules."""
    n = mol.num_atoms
    adj = mol.adjacency()
    ring_atom = mol.ring_atom_flags()
    z = [a.atomic_num for a in mol.atoms]

    carbonyl_c = [False] * n   # C with a double bond to O (acyl / carboxyl)
    sulfonyl_s = [False] * n   # S with two double-bonded O
    for i in range(n):
        if z[i] == 6:
            for v, bi in adj[i]:
                if z[v] == 8 and mol.bonds[bi].bond_type == BondType.DOUBLE:
                    carbonyl_c[i] = True
        elif z[i] == 16:
            n_dbl_o = sum(
                1 for v, bi in adj[i]
                if z[v] == 8 and mol.bonds[bi].bond_type == BondType.DOUBLE
            )
            sulfonyl_s[i] = n_dbl_o >= 2
    return adj, ring_atom, z, carbonyl_c, sulfonyl_s


# ---- exact BRICS environments (Degen et al. 2008, L1-L16) ----
#
# Transcription of the published environment SMARTS into graph predicates.
# SMARTS conventions honored: [C]/[N]/... match ALIPHATIC atoms only,
# [c]/[n]/... aromatic only; Dk counts explicit connections (heavy-atom
# degree here — implicit hydrogens are not graph atoms); '-' single bond,
# '=' double, ':' aromatic, '@' ring bond, '!@' acyclic; $(...) recursive
# environments anchored at the first atom. Dummy-atom (#0) and explicit-H
# (#1) alternatives are dropped — neither occurs in parsed input molecules.

def _brics_env_table(mol: Mol):
    """Bitmask of matched environments per atom: bit k set <=> atom matches
    L(k) for k in 1..16 (L7a == L7b == bit 7)."""
    n = mol.num_atoms
    adj = mol.adjacency()
    ring_bond = mol.ring_bond_flags()
    ring_atom = mol.ring_atom_flags()
    z = [a.atomic_num for a in mol.atoms]
    arom = [a.is_aromatic for a in mol.atoms]
    chg = [a.formal_charge for a in mol.atoms]
    BT = BondType

    # per-atom incident (other, bond_type, is_ring_bond)
    inc = [[(v, mol.bonds[bi].bond_type, ring_bond[bi]) for v, bi in adj[i]]
           for i in range(n)]

    def dbl_o_partners(i):
        return [v for v, t, _ in inc[i] if z[v] == 8 and t == BT.DOUBLE]

    def has(i, pred):
        return any(pred(v, t, rb) for v, t, rb in inc[i])

    def two_distinct(i, pred_a, pred_b):
        """Two DISTINCT neighbors matching pred_a resp. pred_b (SMARTS
        branch atoms map to distinct atoms)."""
        for va, ta, ra in inc[i]:
            if not pred_a(va, ta, ra):
                continue
            for vb, tb, rb in inc[i]:
                if vb != va and pred_b(vb, tb, rb):
                    return True
        return False

    env = [0] * n
    for i in range(n):
        deg = len(adj[i])
        zi, ai = z[i], arom[i]
        m = 0
        if zi == 6 and not ai:
            no_dbl = not has(i, lambda v, t, r: t == BT.DOUBLE)
            # L1 '[C;D3]([#0,#6,#7,#8])(=O)'
            if deg == 3 and two_distinct(
                    i, lambda v, t, r: z[v] in (6, 7, 8),
                    lambda v, t, r: z[v] == 8 and t == BT.DOUBLE):
                m |= 1 << 1
            # L4 '[C;!D1;!$(C=*)]-;!@[#6]'
            if deg >= 2 and no_dbl and has(
                    i, lambda v, t, r: t == BT.SINGLE and not r
                    and z[v] == 6):
                m |= 1 << 4
            # L6 '[C;D3;!R](=O)-;!@[#0,#6,#7,#8]'
            if (deg == 3 and not ring_atom[i] and dbl_o_partners(i)
                    and has(i, lambda v, t, r: t == BT.SINGLE and not r
                            and z[v] in (6, 7, 8))):
                m |= 1 << 6
            # L7a/L7b '[C;D2,D3]-[#6]' (joined by an acyclic DOUBLE bond)
            if deg in (2, 3) and has(
                    i, lambda v, t, r: t == BT.SINGLE and z[v] == 6):
                m |= 1 << 7
            # L8 '[C;!R;!D1;!$(C!-*)]'
            if (deg >= 2 and not ring_atom[i]
                    and all(t == BT.SINGLE for _, t, _ in inc[i])):
                m |= 1 << 8
            # L13 '[C;$(C(-;@[C,N,O,S])-;@[N,O,S])]'
            if two_distinct(
                    i, lambda v, t, r: t == BT.SINGLE and r
                    and z[v] in (6, 7, 8, 16) and not arom[v],
                    lambda v, t, r: t == BT.SINGLE and r
                    and z[v] in (7, 8, 16) and not arom[v]):
                m |= 1 << 13
            # L15 '[C;$(C(-;@C)-;@C)]'
            if two_distinct(
                    i, lambda v, t, r: t == BT.SINGLE and r and z[v] == 6
                    and not arom[v],
                    lambda v, t, r: t == BT.SINGLE and r and z[v] == 6
                    and not arom[v]):
                m |= 1 << 15
        elif zi == 6 and ai:
            # L14 '[c;$(c(:[c,n,o,s]):[n,o,s])]'
            if two_distinct(
                    i, lambda v, t, r: t == BT.AROMATIC
                    and z[v] in (6, 7, 8, 16) and arom[v],
                    lambda v, t, r: t == BT.AROMATIC
                    and z[v] in (7, 8, 16) and arom[v]):
                m |= 1 << 14
            # L16 '[c;$(c(:c):c)]'
            if two_distinct(
                    i, lambda v, t, r: t == BT.AROMATIC and z[v] == 6
                    and arom[v],
                    lambda v, t, r: t == BT.AROMATIC and z[v] == 6
                    and arom[v]):
                m |= 1 << 16
        elif zi == 7 and not ai:
            # L5 '[N;!D1;!$(N=*);!$(N-[!#6;!#16;!#0;!#1]);
            #     !$([N;R]@[C;R]=O)]'
            lactam = ring_atom[i] and has(
                i, lambda v, t, r: r and z[v] == 6 and not arom[v]
                and dbl_o_partners(v))
            if (deg >= 2
                    and not has(i, lambda v, t, r: t == BT.DOUBLE)
                    and not has(i, lambda v, t, r: t == BT.SINGLE
                                and z[v] not in (6, 16))
                    and not lactam):
                m |= 1 << 5
            # L10 '[N;R;$(N(@C(=O))@[C,N,O,S])]'
            if ring_atom[i] and two_distinct(
                    i, lambda v, t, r: r and z[v] == 6 and not arom[v]
                    and dbl_o_partners(v),
                    lambda v, t, r: r and z[v] in (6, 7, 8, 16)
                    and not arom[v]):
                m |= 1 << 10
        elif zi == 7 and ai:
            # L9 '[n;+0;$(n(:[c,n,o,s]):[c,n,o,s])]'
            if chg[i] == 0 and two_distinct(
                    i, lambda v, t, r: t == BT.AROMATIC
                    and z[v] in (6, 7, 8, 16) and arom[v],
                    lambda v, t, r: t == BT.AROMATIC
                    and z[v] in (6, 7, 8, 16) and arom[v]):
                m |= 1 << 9
        elif zi == 8 and not ai:
            # L3 '[O;D2]-;!@[#0,#6,#1]'
            if deg == 2 and has(
                    i, lambda v, t, r: t == BT.SINGLE and not r
                    and z[v] == 6):
                m |= 1 << 3
        elif zi == 16 and not ai:
            n_dbl_o = len(dbl_o_partners(i))
            # L11 '[S;D2](-;!@[#0,#6])'
            if deg == 2 and has(
                    i, lambda v, t, r: t == BT.SINGLE and not r
                    and z[v] == 6):
                m |= 1 << 11
            # L12 '[S;D4]([#6,#0])(=O)(=O)'
            if deg == 4 and n_dbl_o >= 2 and has(
                    i, lambda v, t, r: z[v] == 6):
                m |= 1 << 12
        env[i] = m
    return env


# The published environment pairs (RDKit BRICS reactionDefs), all joined
# by acyclic single bonds except the L7=L7 olefin cut.
_BRICS_PAIRS_SINGLE = (
    (1, 3), (1, 5), (1, 10),
    (3, 4), (3, 13), (3, 14), (3, 15), (3, 16),
    (4, 5), (4, 11),
    (5, 12), (5, 13), (5, 14), (5, 15), (5, 16),
    (6, 13), (6, 14), (6, 15), (6, 16),
    (8, 9), (8, 10), (8, 13), (8, 14), (8, 15), (8, 16),
    (9, 13), (9, 14), (9, 15), (9, 16),
    (10, 13), (10, 14), (10, 15), (10, 16),
    (11, 13), (11, 14), (11, 15), (11, 16),
    (13, 14), (13, 15), (13, 16),
    (14, 14), (14, 15), (14, 16),
    (15, 16),
    (16, 16),
)


def find_brics_bonds(mol: Mol, rules: str = "brics16") \
        -> list[tuple[int, int]]:
    """Return (a1, a2) pairs of cleavable bonds.

    rules='brics16' (default): the exact 16-environment BRICS table;
    bonds are emitted in environment-pair order like RDKit's
    FindBRICSBonds, deduplicated. rules='approx': the round-1 7-rule
    approximation (kept for round-1 motif-vocabulary compatibility)."""
    if rules == "approx":
        return _find_brics_bonds_approx(mol)
    if rules != "brics16":
        raise ValueError(f"unknown BRICS rule set {rules!r}")

    env = _brics_env_table(mol)
    ring_bond = mol.ring_bond_flags()
    out: list[tuple[int, int]] = []
    done: set[frozenset] = set()
    for a, b in _BRICS_PAIRS_SINGLE:
        for bi, bond in enumerate(mol.bonds):
            if bond.bond_type != BondType.SINGLE or ring_bond[bi]:
                continue
            i, j = bond.a1, bond.a2
            key = frozenset((i, j))
            if key in done:
                continue
            if (env[i] >> a & 1 and env[j] >> b & 1):
                out.append((i, j))
                done.add(key)
            elif (env[i] >> b & 1 and env[j] >> a & 1):
                out.append((j, i))
                done.add(key)
    # L7 == L7 across an acyclic DOUBLE bond (olefin cleavage)
    for bi, bond in enumerate(mol.bonds):
        if bond.bond_type != BondType.DOUBLE or ring_bond[bi]:
            continue
        i, j = bond.a1, bond.a2
        key = frozenset((i, j))
        if key not in done and env[i] >> 7 & 1 and env[j] >> 7 & 1:
            out.append((i, j))
            done.add(key)
    return out


def _find_brics_bonds_approx(mol: Mol) -> list[tuple[int, int]]:
    """Round-1 7-rule approximation: acyclic SINGLE bonds at prototypical
    synthetically-accessible positions (amide, ester, amine, ether,
    sulfonamide, thioether, ring-attachment), in bond order."""
    adj, ring_atom, z, carbonyl_c, sulfonyl_s = _env_flags(mol)
    ring_bond = mol.ring_bond_flags()
    out: list[tuple[int, int]] = []

    def heavy_degree(i: int) -> int:
        return sum(1 for v, _ in adj[i] if z[v] != 1)

    for bi, b in enumerate(mol.bonds):
        if b.bond_type != BondType.SINGLE or ring_bond[bi]:
            continue
        i, j = b.a1, b.a2
        if z[i] == 1 or z[j] == 1:
            continue
        if heavy_degree(i) < 2 or heavy_degree(j) < 2:
            # Cutting a terminal bond would produce a lone atom; BRICS
            # environments all require substituted partners.
            continue
        cut = False
        for a, c in ((i, j), (j, i)):
            za, zc = z[a], z[c]
            # amide / ester / acyl: C(=O)-N, C(=O)-O, C(=O)-C(ring)
            if carbonyl_c[a] and zc in (7, 8) and not mol.atoms[c].is_aromatic:
                cut = True
            # sulfonamide: S(=O)(=O)-N
            elif sulfonyl_s[a] and zc == 7:
                cut = True
            # amine: C-N with aliphatic N not alpha to carbonyl
            elif (za == 6 and zc == 7 and not carbonyl_c[a]
                  and not mol.atoms[c].is_aromatic
                  and not any(carbonyl_c[v] for v, _ in adj[c])):
                cut = True
            # ether: C-O with aliphatic O, C not acyl
            elif (za == 6 and zc == 8 and not carbonyl_c[a]
                  and not mol.atoms[c].is_aromatic
                  and heavy_degree(c) >= 2):
                cut = True
            # thioether / C-S
            elif za == 6 and zc == 16 and not sulfonyl_s[c]:
                cut = True
            # ring attachment: ring atom to acyclic carbon chain
            elif ring_atom[a] and not ring_atom[c] and zc == 6:
                cut = True
            if cut:
                break
        if cut:
            out.append((i, j))
    return out


def brics_decompose(mol: Mol) -> tuple[list[list[int]], list[tuple[int, int]]]:
    """Motif decomposition with the reference's exact control flow
    (ref utils/clique.py:11-90):

      1. single-atom molecule -> one singleton clique, no edges (:13-14)
      2. no BRICS bonds -> the whole molecule as one clique, no edges (:24-25)
      3. cut BRICS bonds (:27-33), then ring/non-ring junction bonds (:36-45),
         then isolate acyclic atoms with >2 neighbors (:48-58)
      4. merge overlapping cliques (:61-71) == connected components of the
         graph with cut bonds removed
      5. one motif-graph edge per cut bond between the containing cliques
         (:74-89)
    """
    n = mol.num_atoms
    if n == 1:
        return [[0]], []

    brics_bonds = find_brics_bonds(mol)
    if not brics_bonds:
        return [list(range(n))], []

    cut = {frozenset(b) for b in brics_bonds}
    cut_list: list[tuple[int, int]] = list(brics_bonds)

    ring_atom = mol.ring_atom_flags()
    adj = mol.adjacency()

    # ring / non-ring junction bonds (only those not already cut)
    for b in mol.bonds:
        key = frozenset((b.a1, b.a2))
        if key in cut:
            continue
        if ring_atom[b.a1] != ring_atom[b.a2]:
            cut.add(key)
            cut_list.append((b.a1, b.a2))

    # high-degree acyclic atoms become their own motif: cut all their bonds
    for i in range(n):
        if len(adj[i]) > 2 and not ring_atom[i]:
            for v, _ in adj[i]:
                key = frozenset((i, v))
                if key not in cut:
                    cut.add(key)
                    cut_list.append((i, v))

    # connected components after removing cut bonds
    comp = [-1] * n
    n_comp = 0
    for i in range(n):
        if comp[i] != -1:
            continue
        comp[i] = n_comp
        stack = [i]
        while stack:
            u = stack.pop()
            for v, _ in adj[u]:
                if comp[v] == -1 and frozenset((u, v)) not in cut:
                    comp[v] = n_comp
                    stack.append(v)
        n_comp += 1

    cliques: list[list[int]] = [[] for _ in range(n_comp)]
    for i in range(n):
        cliques[comp[i]].append(i)

    edges = [(comp[a], comp[b]) for a, b in cut_list if comp[a] != comp[b]]
    return cliques, edges


def clique_mol_smiles(mol: Mol, atoms: list[int]) -> str:
    """Canonical SMILES key of a clique fragment — the vocabulary key used in
    place of get_clique_mol + get_smiles (ref utils/clique.py:92-98,133-134)."""
    frag = mol.extract_atoms(atoms)
    return canonical_smiles(frag)

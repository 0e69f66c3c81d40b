"""Drug-like SMILES corpora and ClinTox-format task sets from a seed.

The benchmark's own generator, grown from the fragment idea of the port's
`data/synthetic.py`: a molecule is a chain of one to four ring cores
(benzene, pyridine, thiophene, naphthalene, indole, piperazine, ...) joined
through linkers (amide, ether, sulfonamide, methylene chains), each core
carrying up to two substituents, with an optional head and tail group.
Strings are assembled from the fragments without parsing anything: every
fragment is written so that each atom keeps a legal valence wherever the
chain or a substituent attaches, and ring-closure digits are reused only
after their ring has closed. The port's featurizer parses what this
writes; the CPU tests hold every generated molecule to the atom and bond
counts that `signature` works out from the fragments alone.

Draws come from numpy's PCG64 seeded with the whole `seed` (any size), so
a seed gives the same corpus on every machine. The mixing parameters (how
many cores, how often a slot is filled) come from a traffic file; the
fragment vocabulary is fixed here.
"""

from __future__ import annotations

import csv
import os
import re

import numpy as np

# ring cores: {r1} / {r2} the core's ring digits, {s1} / {s2} substituent
# slots ("" or "(SUB)"). The chain enters at the first atom and leaves from
# the last atom outside a branch (the atom before a closing "(...)").
CORES = [
    "c{r1}c{s2}cc{s1}c(c{r1})",           # benzene
    "c{r1}cnc{s1}c(c{r1})",              # pyridine
    "c{r1}ncc{s1}c(n{r1})",              # pyrimidine
    "C{r1}CC{s1}CC(C{r1}){s2}",          # cyclohexane
    "C{r1}CN{s1}CC(C{r1})",              # piperidine
    "N{r1}CCN(CC{r1})",                  # piperazine
    "C{r1}COC{s1}C(C{r1})",              # oxane
    "c{r1}cc{s1}c(s{r1})",               # thiophene
    "c{r1}cc{s1}c(o{r1})",               # furan
    "c{r1}cc{s1}c([nH]{r1})",            # pyrrole
    "c{r1}nc{s1}c(s{r1})",               # thiazole
    "C{r1}CC{s1}C(C{r1})",               # cyclopentane
    "c{r1}cc{s1}c{r2}ccccc{r2}c{r1}",    # naphthalene
    "c{r1}cc{s1}c{r2}[nH]ccc{r2}c{r1}",  # indole
    "c{r1}cc{s1}c{r2}ncccc{r2}c{r1}",    # quinoline
    "c{r1}cc{s1}c{r2}OCOc{r2}c{r1}",     # benzodioxole
]

# linkers between two cores ("" bonds them directly, as in biphenyl)
LINKERS = [
    "", "C", "CC", "C(=O)N", "NC(=O)", "O", "OC", "S(=O)(=O)N", "CN",
    "C(=O)", "CCO", "N", "CC(C)", "C=C", "C(=O)NC", "OCC", "NC(=O)N", "C#C",
]

# substituents on a core slot or at the tail; {r3} a ring digit of its own
SUBSTITUENTS = [
    "C", "CC", "F", "Cl", "Br", "O", "OC", "N", "C#N", "C(=O)O",
    "C(=O)N", "C(F)(F)F", "OCC", "N(C)C", "C(=O)C", "S(=O)(=O)C",
    "c{r3}ccccc{r3}", "CO", "CN", "OC(F)(F)F", "C(C)C", "C(=O)OC",
    "S(=O)(=O)N", "C{r3}CC{r3}", "CCN(C)C", "N{r3}CCOCC{r3}",
]

# head groups that start a molecule; each ends on an atom with a free
# valence, which bonds to the first core's first atom
HEADS = [
    "CC", "CO", "COC(=O)", "CN", "CCN", "FC(F)(F)", "OC(=O)", "N#C",
    "CC(=O)N", "CS(=O)(=O)", "CC(C)(C)OC(=O)N", "CCOC(=O)",
]

_ELEMENTS = ("C", "N", "O", "S", "F", "Cl", "Br")
_ATOM = re.compile(r"Cl|Br|\[nH\]|[CNOSFcnos]")
_BOND = re.compile(r"Cl|Br|\[nH\]|[CNOSFcnos]|%\d\d|\d")


def _counts(fragment: str) -> np.ndarray:
    """[atoms by element (7), ring closures] of one fragment with its ring
    digits written as 1 (the opening and the closing of a ring both count,
    so closures = digits / 2)."""
    s = fragment.format(r1="1", r2="2", r3="3", s1="", s2="")
    out = np.zeros(len(_ELEMENTS) + 1, np.int64)
    for tok in _ATOM.findall(s):
        el = {"c": "C", "n": "N", "o": "O", "s": "S",
              "[nH]": "N"}.get(tok, tok)
        out[_ELEMENTS.index(el)] += 1
    digits = sum(1 for tok in _BOND.findall(s) if tok[0].isdigit())
    out[-1] = digits // 2
    return out


_CORE_COUNTS = np.stack([_counts(f) for f in CORES])
_LINK_COUNTS = np.stack([_counts(f) for f in LINKERS])
_SUB_COUNTS = np.stack([_counts(f) for f in SUBSTITUENTS])
_HEAD_COUNTS = np.stack([_counts(f) for f in HEADS])


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed), stream]))


def generate(n: int, seed: int, params: dict, stream: int = 0):
    """(SMILES list, signature [n, 9] int64, scaffold keys) of n molecules
    from `seed`.

    params (a traffic file's "molecules" block): core_count_probs (the
    chance of 1, 2, ... cores), slot_fill (the chance a core's substituent
    slot is filled), head_prob, tail_prob. A signature row is the atoms of
    each element in _ELEMENTS, the heavy atoms and the bonds, worked out
    from the fragments alone (a connected molecule has atoms - 1 bonds
    plus one per ring closure). A scaffold key is what of the molecule's
    construction its Murcko scaffold keeps: the cores in order with the
    ring-bearing substituents in their slots, the linkers between them and
    a ring-bearing tail (heads and ring-free substituents hang off the
    scaffold and are pruned; linkers lie between rings and stay). Equal
    keys give equal scaffolds, so the scaffold partition of a corpus is a
    union of its key groups."""
    rng = _rng(seed, stream)
    probs = np.asarray(params["core_count_probs"], np.float64)
    n_cores = 1 + rng.choice(len(probs), size=n, p=probs / probs.sum())
    kmax = len(probs)
    core = rng.integers(0, len(CORES), size=(n, kmax))
    link = rng.integers(0, len(LINKERS), size=(n, kmax))
    sub = rng.integers(0, len(SUBSTITUENTS), size=(n, kmax, 2))
    fill = rng.random((n, kmax, 2)) < params["slot_fill"]
    head = rng.integers(0, len(HEADS), size=n)
    has_head = rng.random(n) < params["head_prob"]
    tail = rng.integers(0, len(SUBSTITUENTS), size=n)
    has_tail = rng.random(n) < params["tail_prob"]

    used = np.arange(kmax)[None, :] < n_cores[:, None]       # [n, kmax]
    # a core's slot exists only where its template has it
    has_slot = np.array([[("{s1}" in c), ("{s2}" in c)] for c in CORES])
    slot_on = fill & has_slot[core] & used[:, :, None]
    link_on = used & (np.arange(kmax)[None, :] < n_cores[:, None] - 1)

    counts = (np.einsum("nk,nkc->nc", used.astype(np.int64),
                        _CORE_COUNTS[core])
              + np.einsum("nk,nkc->nc", link_on.astype(np.int64),
                          _LINK_COUNTS[link])
              + np.einsum("nks,nksc->nc", slot_on.astype(np.int64),
                          _SUB_COUNTS[sub])
              + has_head[:, None] * _HEAD_COUNTS[head]
              + has_tail[:, None] * _SUB_COUNTS[tail])
    atoms = counts[:, :-1].sum(axis=1)
    sig = np.concatenate([counts[:, :-1], atoms[:, None],
                          (atoms - 1 + counts[:, -1])[:, None]], axis=1)

    out = []
    for i in range(n):
        parts = [HEADS[head[i]]] if has_head[i] else []
        for k in range(n_cores[i]):
            slots = {}
            for j, name in enumerate(("s1", "s2")):
                slots[name] = ("(" + SUBSTITUENTS[sub[i, k, j]].format(r3="3")
                               + ")" if slot_on[i, k, j] else "")
            parts.append(CORES[core[i, k]].format(r1="1", r2="2", **slots))
            if link_on[i, k]:
                parts.append(LINKERS[link[i, k]])
        if has_tail[i]:
            parts.append(SUBSTITUENTS[tail[i]].format(r3="3"))
        out.append("".join(parts))
    ringed = np.array(["{r3}" in f for f in SUBSTITUENTS])
    keys = []
    for i in range(n):
        chain = tuple(
            (int(core[i, k]),
             *(int(sub[i, k, j]) if slot_on[i, k, j] and ringed[sub[i, k, j]]
               else -1 for j in range(2)),
             int(link[i, k]) if link_on[i, k] else -1)
            for k in range(n_cores[i]))
        tail_key = (int(tail[i]) if has_tail[i] and ringed[tail[i]] else -1)
        keys.append((chain, tail_key))
    return out, sig, keys


def heavy_atom_stats(sig: np.ndarray) -> dict:
    """The heavy-atom distribution of a signature array."""
    atoms = sig[:, len(_ELEMENTS)]
    q = np.percentile(atoms, [5, 25, 50, 75, 95, 99])
    return {"mean": float(atoms.mean()), "max": int(atoms.max()),
            "min": int(atoms.min()),
            "p5_25_50_75_95_99": [float(x) for x in q]}


def graph_signature(atom_type: np.ndarray, n_bonds: int) -> np.ndarray:
    """A featurized molecule's signature row (heavy atoms only), from its
    atom types (atomic number - 1) and bond count (bonds to hydrogens
    left out by the caller)."""
    z = atom_type + 1
    els = [6, 7, 8, 16, 9, 17, 35]
    counts = [int((z == e).sum()) for e in els]
    return np.array(counts + [sum(counts), n_bonds], np.int64)


def write_task_csv(path: str, n: int, seed: int, params: dict,
                   targets: list[str], positive_rates: list[float]) -> dict:
    """A MoleculeNet-format CSV of n generated molecules: a smiles column
    and one 0/1 column per target, each positive at its rate (drawn from
    the seed, independent of the molecule). Returns {"smiles", "labels"
    [n, T], "signature", "scaffold_keys"}."""
    smiles, sig, keys = generate(n, seed, params, stream=1)
    rng = _rng(seed, 2)
    labels = (rng.random((n, len(targets)))
              < np.asarray(positive_rates)[None, :]).astype(np.int64)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["smiles", *targets])
        for s, row in zip(smiles, labels):
            w.writerow([s, *row.tolist()])
    return {"smiles": smiles, "labels": labels, "signature": sig,
            "scaffold_keys": keys}

"""The structural checks behind `correct`: the reference reads each
generated molecule as the port's featurizers do, atom for atom and bond
for bond, and each check flags a batch, a split or a validation set that
differs from the generator's record."""

import json

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.loops import finetune as ft_loop
from benchmark.reference import molecule
from benchmark.traffic import molgen

PARAMS = json.loads((harness.HERE / "traffic" / "finetune_clintox_m6.json")
                    .read_text())["molecules"]


def _batch(graphs) -> dict:
    """A reference-layout batch of featurized molecules, one slot each."""
    at, ch, ng, src, dst, bt, bd = [], [], [], [], [], [], []
    base = 0
    for g_id, g in enumerate(graphs):
        n = g.atom_type.shape[0]
        at.append(torch.as_tensor(g.atom_type).long())
        ch.append(torch.as_tensor(g.chirality).long())
        ng.append(torch.full((n,), g_id, dtype=torch.long))
        src.append(torch.as_tensor(g.edge_src).long() + base)
        dst.append(torch.as_tensor(g.edge_dst).long() + base)
        bt.append(torch.as_tensor(g.bond_type).long())
        bd.append(torch.as_tensor(g.bond_dir).long())
        base += n
    cat = torch.cat
    return {"atom_type": cat(at), "chirality": cat(ch), "node_graph": cat(ng),
            "node_mask": torch.ones(base, dtype=torch.bool), "src": cat(src),
            "dst": cat(dst), "bond_type": cat(bt), "bond_dir": cat(bd),
            "edge_mask": torch.ones(sum(len(x) for x in src),
                                    dtype=torch.bool),
            "graph_mask": torch.ones(len(graphs), dtype=torch.bool)}


def _featurized(n, hydrogens, native, seed=2**31 + 5):
    from molclr_tpu_torch.data.loader import featurize_many

    smiles, _, _ = molgen.generate(n, seed, PARAMS)
    graphs, kept = featurize_many(smiles, add_hs=hydrogens,
                                  prefer_native=native)
    assert kept == list(range(n))
    return smiles, graphs


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("hydrogens", [False, True], ids=["heavy", "hs"])
def test_reference_reads_molecules_as_the_port(hydrogens, native):
    smiles, graphs = _featurized(1500, hydrogens, native)
    got = molecule.batch_molecules(_batch(graphs), len(graphs))
    want = [molecule.expected(s, hydrogens) for s in smiles]
    assert got == want


def _flip(b, field, at):
    b = dict(b)
    b[field] = b[field].clone()
    b[field][at] = (b[field][at] + 1) % 3
    return b


@pytest.mark.parametrize("fault", ["bond_type", "bond_dir", "chirality",
                                   "endpoint", "one_way"])
def test_batch_reading_flags_an_altered_molecule(fault):
    smiles, graphs = _featurized(4, True, False)
    b = _batch(graphs)
    if fault == "endpoint":
        b = dict(b, dst=b["dst"].clone())
        b["dst"][0] = b["dst"][0] + 1 if b["dst"][0] != 1 else 2
    elif fault == "one_way":
        b = dict(b, edge_mask=b["edge_mask"].clone())
        b["edge_mask"][0] = False
    else:
        b = _flip(b, fault, 0)
    got = molecule.batch_molecules(b, len(graphs))
    assert got[0] != molecule.expected(smiles[0], True)
    assert got[1:] == [molecule.expected(s, True) for s in smiles[1:]]


def _task(n=300, seed=3):
    smiles, sig, keys = molgen.generate(n, seed, PARAMS, stream=1)
    labels = np.random.default_rng(seed).integers(0, 2, (n, 2))
    return {"smiles": smiles, "labels": labels, "signature": sig,
            "scaffold_keys": keys}


def _split(gen):
    from molclr_tpu_torch.data.splits import scaffold_split

    return scaffold_split(gen["smiles"], 0.1, 0.1)


def test_split_check_passes_the_ports_split_and_flags_faults():
    gen = _task()
    tr, va, te = _split(gen)
    ok = ft_loop.split_check((tr, va, te), gen["smiles"], gen, 0.1, 0.1)
    assert ok == 0
    # a validation molecule also in train; one left out; a scaffold group
    # cut across train and test
    assert ft_loop.split_check((tr + va[:1], va, te), gen["smiles"], gen,
                               0.1, 0.1) > 0
    assert ft_loop.split_check((tr, va[1:], te), gen["smiles"], gen,
                               0.1, 0.1) > 0
    groups = {}
    for i, k in enumerate(gen["scaffold_keys"]):
        groups.setdefault(k, []).append(i)
    big = next(g for g in groups.values() if len(g) > 1 and g[0] in tr)
    moved = ([i for i in tr if i != big[0]], va, te + [big[0]])
    assert ft_loop.split_check(moved, gen["smiles"], gen, 0.1, 0.1) > 0
    assert ft_loop.split_check((tr, va, te), gen["smiles"][::-1], gen,
                               0.1, 0.1) > 0


def test_valid_check_flags_other_molecules_or_labels():
    from molclr_tpu_torch.data.loader import featurize_many

    gen = _task(60)
    _, va, _ = _split(gen)
    graphs, _ = featurize_many([gen["smiles"][i] for i in va], add_hs=True,
                               prefer_native=False)
    b = _batch(graphs)
    lab = torch.as_tensor(gen["labels"][va], dtype=torch.float32)
    assert ft_loop.valid_check([b], [lab], gen, va) == 0
    wrong = lab.clone()
    wrong[0, 0] = 1 - wrong[0, 0]
    assert ft_loop.valid_check([b], [wrong], gen, va) == 2
    assert ft_loop.valid_check([b], [lab], gen, va[1:]) > 0

"""The traffic generator: the same seed gives the same molecules, every
molecule parses, and its atoms and bonds are the ones worked out from the
fragments."""

import json

import numpy as np
import pytest

from benchmark import harness
from benchmark.traffic import molgen

PARAMS = json.loads((harness.HERE / "traffic" / "pretrain_node_b512.json")
                    .read_text())["molecules"]
CLINTOX = json.loads((harness.HERE / "traffic" / "finetune_clintox_m6.json")
                     .read_text())["molecules"]


@pytest.mark.parametrize("seed", [0, 2**31 + 12345, 2**40 + 3])
def test_repeats_exactly(seed):
    a, sa, ka = molgen.generate(500, seed, PARAMS)
    b, sb, kb = molgen.generate(500, seed, PARAMS)
    assert a == b and np.array_equal(sa, sb) and ka == kb
    c, _, _ = molgen.generate(500, seed + 1, PARAMS)
    assert c != a


def test_every_molecule_parses_with_its_signature():
    from molclr_tpu_torch.data.loader import featurize_many

    smiles, sig, _ = molgen.generate(3000, 2**31 + 5, PARAMS)
    graphs, kept = featurize_many(smiles, prefer_native=False)
    assert kept == list(range(len(smiles)))
    for g, i in zip(graphs, kept):
        got = molgen.graph_signature(g.atom_type, g.edge_src.shape[0] // 2)
        assert np.array_equal(got, sig[i]), smiles[i]
        assert g.max_degree <= 6


def test_drug_like_size():
    _, sig, _ = molgen.generate(20000, 7, PARAMS)
    stats = molgen.heavy_atom_stats(sig)
    assert 20 <= stats["mean"] <= 28
    assert stats["max"] >= 45 and stats["max"] < 128


def test_task_csv_repeats(tmp_path):
    a = molgen.write_task_csv(str(tmp_path / "a" / "t.csv"), 200, 9, PARAMS,
                              ["x", "y"], [0.1, 0.9])
    b = molgen.write_task_csv(str(tmp_path / "b" / "t.csv"), 200, 9, PARAMS,
                              ["x", "y"], [0.1, 0.9])
    assert (tmp_path / "a" / "t.csv").read_text() == \
        (tmp_path / "b" / "t.csv").read_text()
    assert np.array_equal(a["labels"], b["labels"])


def test_clintox_size():
    """The fine-tuning mix imitates ClinTox's 26.2 heavy atoms a molecule
    (OGB's ogbg-molclintox; Hu et al. 2020)."""
    _, sig, _ = molgen.generate(20000, 11, CLINTOX, stream=1)
    assert 25.7 <= molgen.heavy_atom_stats(sig)["mean"] <= 26.7


@pytest.mark.parametrize("params", [PARAMS, CLINTOX], ids=["pubchem",
                                                           "clintox"])
def test_scaffold_keys_refine_the_ports_scaffolds(params):
    """Molecules of one scaffold key have one Murcko scaffold, so a split
    that keeps scaffolds apart keeps the key groups apart."""
    from molclr_tpu_torch.data.splits import generate_scaffold

    smiles, _, keys = molgen.generate(2000, 2**33 + 1, params, stream=1)
    scaffolds = {}
    for s, k in zip(smiles, keys):
        scaffolds.setdefault(k, set()).add(generate_scaffold(s))
    assert all(len(v) == 1 for v in scaffolds.values())
    assert len(scaffolds) < len(smiles)

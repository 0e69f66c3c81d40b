"""The port's native featurizer and packer (molclr_tpu_torch/native/)
against the JAX package's native library and the port's Python featurizer
and packer, on the CPU.

Every array is held equal (tolerance 0, dtypes too): native featurization
with and without hydrogens, one molecule at a time and through the batch
API (the CSV last column too), on synthetic molecules, drugs, the
aromaticity edge cases and invalid SMILES; the native packer at tile 0
and 32, its PackOverflow too, and BatchIterator's dropped molecules over
either packer; featurize_many's process pool against the serial result. A build that fails raises with the compiler's output and
nothing falls back to Python."""

import dataclasses

import numpy as np
import pytest

from molclr_tpu import native as jax_native
from molclr_tpu.data.graphs import pack_batch as jax_pack_batch
from molclr_tpu.data.loader import featurize_many as jax_featurize_many
from molclr_tpu.data.loader import spec_for_graphs as jax_spec_for_graphs
from molclr_tpu.data.synthetic import synthetic_corpus
from molclr_tpu_torch import native
from molclr_tpu_torch.data import graphs as port_graphs
from molclr_tpu_torch.data.featurize import featurize_smiles
from molclr_tpu_torch.data.graphs import GraphBatch, PackOverflow, PadSpec, \
    pack_batch
from molclr_tpu_torch.data.loader import BatchIterator, featurize_many, \
    read_pretrain_smiles, spec_for_graphs

GRAPH_FIELDS = ("atom_type", "chirality", "edge_src", "edge_dst",
                "bond_type", "bond_dir")
BATCH_FIELDS = [f.name for f in dataclasses.fields(GraphBatch)]
DRUGS = [
    "CC(=O)Oc1ccccc1C(=O)O",
    "Cn1cnc2c1c(=O)n(C)c(=O)n2C",
    "CC(C)Cc1ccc(cc1)C(C)C(=O)O",
    "CC1(C)S[C@@H]2[C@H](NC(=O)Cc3ccccc3)C(=O)N2[C@H]1C(=O)O",
    "CN[C@H]1CC[C@@H](c2ccc(Cl)c(Cl)c2)c2ccccc21",
    "[NH4+].[Cl-]", "F/C=C\\F", "O=S(=O)(N)c1ccccc1", "C%10CC%10",
    "[13CH4]",
]
AROMATIC_EDGE = ["c1ccc(cc1)c1ccccc1", "c1ccc(cc1)-c1ccccc1",
                 "Cc1ccccc1c1ccccc1C", "c1ccc(cc1)c1ccncc1",
                 "c1ccc-2c(c1)-c1ccccc1-2", "c1ccc1", "cc", "c1ccccccc1",
                 "c1cc1C"]
INVALID = ["", "C1CC", "((", "[Zz]", "xyz", "c1ccccc1c1"]
# two bond symbols in a row: the Python parser refuses them, JAX's native
# parser takes the second (a fault of its copy of featurizer.cpp, fixed in
# the port's)
DOUBLE_BOND_SYMBOLS = ["C==C", "CC==O", "C=#C", "C-=C", "C:-C", "C/=C"]
EDGE_CASES = DRUGS + AROMATIC_EDGE + INVALID


def assert_graph_equal(a, b, context=""):
    assert (a is None) == (b is None), context
    if a is None:
        return
    for f in GRAPH_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), (context, f)


def assert_batch_equal(a, b):
    for f in BATCH_FIELDS:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.mark.parametrize("add_hs", [False, True])
def test_featurize_matches_jax_native_and_python(add_hs):
    """One molecule at a time: the port's native, JAX's native and the
    port's Python featurizer give the same arrays (None for the same
    SMILES) on 200 synthetic molecules and the edge cases."""
    for s in synthetic_corpus(200, seed=11) + EDGE_CASES:
        got = native.featurize_smiles_native(s, add_hs=add_hs)
        assert_graph_equal(got, featurize_smiles(s, add_hs), s)
        assert_graph_equal(got, jax_native.featurize_smiles_native(
            s, add_hs=add_hs), s)


def test_two_bond_symbols_refused_as_in_python():
    """"C==C" and the like do not parse, natively as in Python; JAX's
    native featurizer takes them."""
    for s in DOUBLE_BOND_SYMBOLS:
        assert featurize_smiles(s) is None, s
        assert native.featurize_smiles_native(s) is None, s
    assert jax_native.featurize_smiles_native("C==C") is not None
    graphs, kept = native.featurize_corpus_native(
        ["C=C"] + DOUBLE_BOND_SYMBOLS + ["C/C=C/C", "C=/C"])
    assert kept == [0, len(DOUBLE_BOND_SYMBOLS) + 1,
                    len(DOUBLE_BOND_SYMBOLS) + 2]
    assert_graph_equal(graphs[2], featurize_smiles("C=/C"))


@pytest.mark.parametrize("add_hs", [False, True])
def test_batch_api_matches_per_molecule_and_jax(add_hs):
    """featurize_corpus_native (one C call) keeps the same molecules as
    the per-molecule calls and JAX's batch API, with the same arrays;
    featurize_corpus_flat holds the same arrays flat."""
    smiles = synthetic_corpus(300, seed=4) + EDGE_CASES
    graphs, kept = native.featurize_corpus_native(smiles, add_hs)
    gj, kj = jax_native.featurize_corpus_native(smiles, add_hs)
    assert kept == kj
    want = [(i, featurize_smiles(s, add_hs)) for i, s in enumerate(smiles)]
    assert kept == [i for i, g in want if g is not None]
    for g, j, i in zip(graphs, gj, kept):
        assert_graph_equal(g, j, smiles[i])
        assert_graph_equal(g, want[i][1], smiles[i])
    nodes, edges, acnt, ecnt = native.featurize_corpus_flat(smiles, add_hs)
    nj, ej, aj, ejc = jax_native.featurize_corpus_flat(smiles, add_hs)
    for mine, theirs in ((nodes, nj), (edges, ej)):
        for f in mine:
            assert mine[f].dtype == theirs[f].dtype
            assert np.array_equal(mine[f], theirs[f]), f
    assert np.array_equal(acnt, aj) and np.array_equal(ecnt, ejc)
    assert acnt.dtype == aj.dtype == np.int64


def test_csv_last_column_and_featurize_many_native(tmp_path):
    """A CSV whose last column holds the SMILES reads as the bare list,
    and featurize_many (native, its degree filter) keeps the molecules
    JAX's featurize_many keeps, with the same arrays, as the Python path
    does."""
    smiles = synthetic_corpus(120, seed=6) + DRUGS + INVALID[1:]
    path = tmp_path / "corpus.csv"
    path.write_text("".join(f"{i},x,{s}\n" for i, s in enumerate(smiles)))
    assert read_pretrain_smiles(str(path)) == smiles
    for add_hs, max_degree in ((False, 6), (True, 4), (False, 3)):
        gp, kp = featurize_many(smiles, add_hs=add_hs, max_degree=max_degree)
        gj, kj = jax_featurize_many(smiles, add_hs=add_hs,
                                    max_degree=max_degree)
        gy, ky = featurize_many(smiles, add_hs=add_hs, max_degree=max_degree,
                                prefer_native=False)
        assert kp == kj == ky
        for a, b, c in zip(gp, gj, gy):
            assert_graph_equal(a, b)
            assert_graph_equal(a, c)


def test_featurize_many_process_pool_equals_serial():
    """The Python featurizer in two spawned processes gives the serial
    result."""
    smiles = synthetic_corpus(60, seed=2) + INVALID[1:]
    gs, ks = featurize_many(smiles, prefer_native=False)
    gp, kp = featurize_many(smiles, processes=2, prefer_native=False)
    assert ks == kp
    for a, b in zip(gs, gp):
        assert_graph_equal(a, b)


@pytest.mark.parametrize("tile", [0, 32])
def test_native_packer_matches_python_and_jax(tile):
    """pack_batch through the native packer equals the Python packer and
    JAX's pack_batch field for field (spec sized by either package, the
    same), with and without hydrogens."""
    for add_hs, seed in ((False, 3), (True, 5)):
        smiles = synthetic_corpus(64, seed=seed)
        gp, _ = featurize_many(smiles, add_hs=add_hs)
        gj, _ = jax_featurize_many(smiles, add_hs=add_hs)
        spec = spec_for_graphs(gp, 32, tile=tile * (1 + add_hs))
        assert dataclasses.asdict(spec) == dataclasses.asdict(
            jax_spec_for_graphs(gj, 32, tile=tile * (1 + add_hs)))
        calls = native.calls["pack_batch"]
        got = pack_batch(gp[:32], spec)
        assert native.calls["pack_batch"] == calls + 1
        assert_batch_equal(got, pack_batch(gp[:32], spec,
                                           prefer_native=False))
        assert_batch_equal(got, jax_pack_batch(gj[:32], spec))


@pytest.mark.parametrize("tile", [0, 32])
def test_native_overflow_matches_jax(tile):
    """Too many graphs, nodes, edges or too high a degree: the native
    packer raises PackOverflow where the Python packer and JAX's do. A
    total above its capacity carries the Python packer's message, which
    names the bound (JAX's native message names the spec, whose n_edges
    made BatchIterator take every overflow for an edge overflow); a degree
    carries JAX's native message."""
    gp, _ = featurize_many(synthetic_corpus(40, seed=1))
    gj, _ = jax_featurize_many(synthetic_corpus(40, seed=1))
    base = spec_for_graphs(gp, 8, tile=tile)
    n = base.n_nodes if not tile else 2 * tile
    for spec, same_as in ((dataclasses.replace(base, n_graphs=4), 1),
                          (PadSpec(8, n, 16, base.max_degree, tile), 1),
                          (dataclasses.replace(base, n_nodes=tile or 24), 1),
                          (dataclasses.replace(base, max_degree=1), 2)):
        errors = []
        for fn, gs in ((lambda g, s: pack_batch(g, s), gp),
                       (lambda g, s: pack_batch(g, s, prefer_native=False),
                        gp), (jax_pack_batch, gj)):
            with pytest.raises(PackOverflow if fn is not jax_pack_batch
                               else Exception) as e:
                fn(gs[:8], spec)
            errors.append(str(e.value))
        assert errors[0] == errors[same_as]


def _overflowing(kind, tile):
    """40 molecules and a spec whose batches of 8 overflow `kind`; 8 are
    salts of 20 ions, the most atoms and no bonds, so that dropping by
    atoms and dropping by edges part ways."""
    gp, _ = featurize_many(synthetic_corpus(32, seed=7)
                           + [".".join(["[Na+]", "[Cl-]"] * 10)] * 8)
    spec = spec_for_graphs(gp, 8, tile=tile)
    atoms = np.array([g.n_atoms for g in gp])
    edges = np.array([g.edge_src.shape[0] for g in gp])
    if kind == "nodes":
        # at tile 32 some batches hold their atoms but not their tile
        # alignment: a tile-slot overflow
        n = int(8 * atoms.mean())
        return gp, dataclasses.replace(spec, n_nodes=n // tile * tile
                                       if tile else n)
    return gp, dataclasses.replace(
        spec, n_edges=int(8 * edges.mean()) // 2 * 2)


@pytest.mark.parametrize("kind,tile", [("nodes", 0), ("edges", 0),
                                       ("nodes", 32), ("edges", 32)])
def test_batch_iterator_drops_as_the_python_packer(kind, tile):
    """Where a batch overflows its nodes, its edges or its tile slots,
    BatchIterator over the native packer drops the same molecules as over
    the Python packer (the one with the most atoms, or the most edges for
    an edge overflow) and yields the same batches."""
    gp, spec = _overflowing(kind, tile)
    runs = []
    for prefer in (True, False):
        it = BatchIterator(gp, spec, seed=3, prefer_native=prefer)
        with pytest.warns(UserWarning, match="dropped"):
            runs.append(list(it))
    assert len(runs[0]) == len(runs[1]) == 5
    for (a, _, ia), (b, _, ib) in zip(*runs):
        assert np.array_equal(ia, ib)
        assert_batch_equal(a, b)
    assert sum(len(i) for _, _, i in runs[0]) < 40


def test_oversized_spec_packs_in_python():
    """A spec beyond the native packer's node slots packs with the Python
    packer where the caller asks for it; pack_batch and the indexed packer
    refuse it rather than fall back (JAX's pack_batch falls back
    unasked)."""
    gp, _ = featurize_many(synthetic_corpus(8, seed=1))
    spec = PadSpec(8, native.MAX_PACK_NODES + 8, 512)
    calls = native.calls["pack_batch"]
    with pytest.raises(ValueError, match="prefer_native=False"):
        pack_batch(gp, spec)
    got = pack_batch(gp, spec, prefer_native=False)
    assert native.calls["pack_batch"] == calls
    assert got.atom_type.shape == (native.MAX_PACK_NODES + 8,)
    with pytest.raises(ValueError, match="node slots"):
        native.IndexedPacker(None, spec)


def test_failed_build_raises_instead_of_falling_back(tmp_path, monkeypatch):
    """With no compiler, or a source that does not compile, the first
    native call raises with the compiler's output, featurize_many and
    pack_batch raise rather than run Python; prefer_native=False still
    runs the Python path. The library is
    built under build/native/, never next to the source."""
    assert native.lib_path().parent.name == "native"
    assert native.lib_path().parent.parent.name == "build"
    assert native.lib_path().parent != native.SRC.parent
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="no-such-g"):
        native.featurize_smiles_native("CCO")
    with pytest.raises(RuntimeError):
        featurize_many(["CCO"])
    gp, _ = featurize_many(["CCO", "c1ccccc1"], prefer_native=False)
    spec = spec_for_graphs(gp, 2)
    with pytest.raises(RuntimeError):
        port_graphs.pack_batch(gp, spec)
    assert port_graphs.pack_batch(gp, spec, prefer_native=False) is not None
    bad = tmp_path / "featurizer.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(native, "CXX", "g++")
    monkeypatch.setattr(native, "SRC", bad)
    with pytest.raises(RuntimeError, match="error"):
        native.build()
    assert not list((tmp_path / "build").glob("*.so"))

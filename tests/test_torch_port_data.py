"""The PyTorch port's host side (molclr_tpu_torch.chem / .data) against the
JAX package, and the port's isolation from JAX.

Featurization, corpus generation and packing are integer / boolean work,
so the port must agree with the JAX package bit for bit (tolerance 0)."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from molclr_tpu.data import featurize_smiles as jax_featurize_smiles
from molclr_tpu.data import pack_batch as jax_pack_batch
from molclr_tpu.data.loader import featurize_many as jax_featurize_many
from molclr_tpu.data.loader import read_pretrain_smiles as jax_read_smiles
from molclr_tpu.data.loader import spec_for_graphs as jax_spec_for_graphs
from molclr_tpu.data.synthetic import synthetic_corpus as jax_corpus
from molclr_tpu_torch.cli import embed as port_embed
from molclr_tpu_torch.data.featurize import featurize_smiles
from molclr_tpu_torch.data.graphs import GraphBatch, PackOverflow, PadSpec
from molclr_tpu_torch.data.graphs import pack_batch
from molclr_tpu_torch.data.loader import (
    featurize_many,
    read_pretrain_smiles,
    spec_for_graphs,
)
from molclr_tpu_torch.data.synthetic import synthetic_corpus

ROOT = Path(__file__).resolve().parents[1]
GRAPH_FIELDS = ("atom_type", "chirality", "edge_src", "edge_dst",
                "bond_type", "bond_dir")
# molecules beyond the synthetic templates: charges, stereo, aromatic N
EXTRA_SMILES = [
    "CC(=O)Oc1ccccc1C(=O)O",
    "Cn1cnc2c1c(=O)n(C)c(=O)n2C",
    "CC1(C)S[C@@H]2[C@H](NC(=O)Cc3ccccc3)C(=O)N2[C@H]1C(=O)O",
    "F/C=C/F",
    "[NH4+].[Cl-]",
    "C1CC",            # unparseable: dropped by both
]


@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_corpus_matches_jax(seed):
    assert synthetic_corpus(64, seed=seed) == jax_corpus(64, seed=seed)


def test_featurize_matches_jax():
    for s in jax_corpus(48, seed=3) + EXTRA_SMILES:
        gp, gj = featurize_smiles(s), jax_featurize_smiles(s)
        assert (gp is None) == (gj is None), s
        if gp is None:
            continue
        for f in GRAPH_FIELDS:
            a, b = getattr(gp, f), getattr(gj, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), (s, f)


def test_read_and_featurize_many_match_jax(tmp_path):
    corpus = tmp_path / "c.csv"
    smiles = jax_corpus(20, seed=5) + EXTRA_SMILES
    corpus.write_text("\n".join(f"{i},{s}" for i, s in enumerate(smiles))
                      + "\n\n")
    assert read_pretrain_smiles(str(corpus)) == jax_read_smiles(str(corpus))
    gp, kp = featurize_many(smiles)
    gj, kj = jax_featurize_many(smiles, prefer_native=False)
    assert kp == kj and len(gp) == len(gj)
    for a, b in zip(gp, gj):
        for f in GRAPH_FIELDS:
            assert np.array_equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("tile,sizing,batch", [
    (32, "max", 24), (32, "total", 24), (0, "total", 24), (64, "max", 40)])
def test_spec_and_pack_bit_equal_to_jax(tile, sizing, batch):
    smiles = jax_corpus(batch, seed=11)
    gp = [featurize_smiles(s) for s in smiles]
    gj = [jax_featurize_smiles(s) for s in smiles]
    sp = spec_for_graphs(gp, batch, tile=tile, sizing=sizing)
    sj = jax_spec_for_graphs(gj, batch, tile=tile, sizing=sizing)
    assert (sp.n_graphs, sp.n_nodes, sp.n_edges, sp.max_degree, sp.tile,
            sp.max_graph_bonds) == (sj.n_graphs, sj.n_nodes, sj.n_edges,
                                    sj.max_degree, sj.tile,
                                    sj.max_graph_bonds)
    bp = pack_batch(gp, sp)
    bj = jax_pack_batch(gj, sj, prefer_native=False)
    names = [f for f in GraphBatch.__dataclass_fields__]
    assert len(names) == 20
    assert names == list(type(bj).__dataclass_fields__)
    for f in names:
        a, b = getattr(bp, f), np.asarray(getattr(bj, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def test_pack_overflow_matches_jax():
    gp = [featurize_smiles(s) for s in jax_corpus(8, seed=2)]
    with pytest.raises(PackOverflow):
        pack_batch(gp, PadSpec(n_graphs=4, n_nodes=512, n_edges=1024))
    with pytest.raises(ValueError):
        PadSpec(n_graphs=4, n_nodes=100, n_edges=64, tile=32)


def test_graph_batch_to_device_types():
    gp = [featurize_smiles(s) for s in jax_corpus(6, seed=4)]
    host = pack_batch(gp, spec_for_graphs(gp, 6, tile=32, sizing="max"))
    dev = host.to("cpu")
    for f in GraphBatch.__dataclass_fields__:
        a, t = getattr(host, f), getattr(dev, f)
        assert isinstance(t, torch.Tensor), f
        assert t.dtype == (torch.bool if a.dtype == bool else torch.int64), f
        assert np.array_equal(t.numpy(), a), f
    assert dev.num_graphs == host.num_graphs == 6
    assert dev.num_nodes == host.num_nodes


# ------------------------------------------------------------- isolation

# the card's machine has none of these; the port reads Orbax checkpoints
# with its own OCDBT reader and zstd decoder
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tensorstore",
             "zstandard", "molclr_tpu")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None)
              in ("__import__",) and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def _port_sources():
    files = sorted((ROOT / "molclr_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_port_never_imports_jax_or_the_jax_package():
    files = _port_sources()
    assert len(files) > 30
    names = {str(f.relative_to(ROOT)) for f in files}
    for mod in ("data/augment.py", "losses/__init__.py", "losses/nt_xent.py",
                "ops/ntxent.py", "train/optim.py", "train/config.py",
                "train/pretrain.py", "train/logging_util.py",
                "cli/pretrain.py", "chem/canon.py", "chem/scaffold.py",
                "chem/brics.py", "data/splits.py", "data/tasks.py",
                "data/motifs.py", "train/metrics.py", "train/finetune.py",
                "cli/finetune.py", "data/regroup.py", "train/graphed.py",
                "data/loader.py", "native/__init__.py", "data/corpus.py",
                "cli/featurize.py", "cli/convert.py", "train/orbax.py",
                "native/zstd.py", "parallel/dp.py", "parallel/multihost.py",
                "train/checkpoints.py", "cli/embed.py"):
        assert f"molclr_tpu_torch/{mod}" in names, mod
    bad = []
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            if top in FORBIDDEN:
                bad.append(f"{path.relative_to(ROOT)}: {mod}")
    assert not bad, bad


def test_isolation_check_catches_a_jax_import(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import os\nfrom molclr_tpu.ops import x\n"
                 "def f():\n    import jax.numpy as jnp\n")
    mods = {m.split(".")[0] for m in _imported_modules(p)}
    assert {"molclr_tpu", "jax"} <= mods
    assert "molclr_tpu_torch" not in FORBIDDEN
    q = tmp_path / "n.py"
    q.write_text("import zstandard\ndef g():\n    import tensorstore as ts\n")
    assert {m.split(".")[0] for m in _imported_modules(q)} <= set(FORBIDDEN)


def test_embed_without_cpu_raises_when_no_gpu(tmp_path, monkeypatch):
    corpus = tmp_path / "c.txt"
    corpus.write_text("CCO\n")
    ckpt = tmp_path / "m.pth"
    torch.save({}, ckpt)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_embed.main([str(corpus), str(tmp_path / "o.npy"),
                         "--checkpoint", str(ckpt)])
    assert not (tmp_path / "o.npy").exists()


def test_embed_rejects_orbax_directory(tmp_path):
    corpus = tmp_path / "c.txt"
    corpus.write_text("CCO\n")
    (tmp_path / "ckpt").mkdir()
    with pytest.raises(ValueError, match="Orbax"):
        port_embed.main([str(corpus), str(tmp_path / "o.npy"),
                         "--checkpoint", str(tmp_path / "ckpt"), "--cpu"])

"""The port's on-disk corpus (data/corpus.py), its CLIs (cli/featurize.py,
cli/convert.py), the corpus-scale tile-unit planner and packer
(data/regroup.py) and the Pretrainer's corpus paths against the JAX
package, on the CPU.

Small sizes (2 layers, emb 16, feat 32, tile 32 or 64, 60-300 synthetic
molecules), f32. Files, splits, specs, unit plans, stacks and streamed
batches are held equal to the JAX package's (tolerance 0, byte for byte
where they are files). The Pretrainer from a corpus is held to the JAX
Pretrainer from the same corpus at the loss limits of
tests/test_torch_port_resident.py::test_pretrainer_units_path_matches_jax
(rtol 1e-5 at the first step, 1e-3 / atol 2e-5 after); a run from the
SMILES text file and one from the corpus built from it are held to each
other exactly (the same batches and draws, the same operations)."""

import dataclasses
import filecmp
import os

import jax
import numpy as np
import pytest
import torch

from molclr_tpu.cli import convert as jax_convert_cli
from molclr_tpu.cli import featurize as jax_featurize_cli
from molclr_tpu.data import corpus as jax_corpus
from molclr_tpu.data import regroup as jax_regroup
from molclr_tpu.data.loader import spec_for_graphs as jax_spec_for_graphs
from molclr_tpu.data.synthetic import synthetic_corpus, write_pretrain_corpus
from molclr_tpu.train.config import ModelConfig as JaxModelConfig
from molclr_tpu.train.config import PretrainConfig as JaxPretrainConfig
from molclr_tpu.train.pretrain import Pretrainer as JaxPretrainer
from molclr_tpu_torch import native
from molclr_tpu_torch.cli import convert as port_convert_cli
from molclr_tpu_torch.cli import featurize as port_featurize_cli
from molclr_tpu_torch.cli import pretrain as port_pretrain_cli
from molclr_tpu_torch.data import corpus, regroup
from molclr_tpu_torch.data.featurize import featurize_smiles
from molclr_tpu_torch.data.graphs import GraphBatch, pack_batch
from molclr_tpu_torch.data.loader import featurize_many, spec_for_graphs
from molclr_tpu_torch.train.checkpoints import state_dict_from_jax, \
    transfer_state
from molclr_tpu_torch.train.config import ModelConfig, PretrainConfig
from molclr_tpu_torch.train.pretrain import Pretrainer

SMALL = dict(num_layers=2, emb_dim=16, feat_dim=32)
FIELDS = [f.name for f in dataclasses.fields(GraphBatch)]
GRAPH_FIELDS = ("atom_type", "chirality", "edge_src", "edge_dst",
                "bond_type", "bond_dir")
BAD = ["C1CC", "((", "[Zz]", "c1ccccc1c1", "C(C)(C)(C)(C)(C)(C)C"]


def _smiles(n, seed, bad=True):
    """Synthetic molecules with a few that do not parse mixed in."""
    out = synthetic_corpus(n, seed=seed)
    if bad:
        for i, s in enumerate(BAD):
            out.insert(7 * i + 3, s)
    return out


def _same_dir(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    match, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert mismatch == [] and errors == [], (mismatch, errors)


def _graph_equal(x, y):
    for f in GRAPH_FIELDS:
        u, v = np.asarray(getattr(x, f)), np.asarray(getattr(y, f))
        assert np.array_equal(u, v) and u.dtype == v.dtype, f


@pytest.mark.parametrize("add_hs", [False, True])
def test_build_corpus_files_equal_jax_and_read_across(tmp_path, add_hs):
    """build_corpus writes byte-identical files to JAX's, natively and in
    Python, over several chunks; each package's DiskCorpus reads the
    other's corpus item for item."""
    smiles = _smiles(150, seed=11)
    dirs = {}
    for who, build in (("port", corpus.build_corpus),
                       ("jax", jax_corpus.build_corpus)):
        for prefer in (True, False):
            d = str(tmp_path / f"{who}_{prefer}")
            build(iter(smiles), d, add_hs=add_hs, chunk_size=40,
                  prefer_native=prefer)
            dirs[who, prefer] = d
    for key in dirs:
        _same_dir(dirs["port", True], dirs[key])
    mine = corpus.DiskCorpus(dirs["jax", True])
    theirs = jax_corpus.DiskCorpus(dirs["port", True])
    n_ok = sum(featurize_smiles(s, add_hs) is not None for s in smiles)
    assert len(mine) == len(theirs) == n_ok
    for i in range(len(mine)):
        _graph_equal(mine[i], theirs[i])
    assert corpus.is_disk_corpus(dirs["jax", True])
    assert not corpus.is_disk_corpus(str(tmp_path / "nothing"))


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    smiles = _smiles(300, seed=3)
    d = str(tmp_path_factory.mktemp("corpus") / "c.mtpu")
    corpus.build_corpus(iter(smiles), d, chunk_size=97)
    return smiles, d


def test_disk_corpus_items_and_vectorized_spec(built):
    """Items equal the in-memory featurization (the molecules that parse,
    in order); a CorpusSubset's items and counts follow its ids; the
    vectorized spec equals the list spec and JAX's, tile 0 and 32."""
    smiles, d = built
    dc = corpus.DiskCorpus(d)
    graphs, kept = featurize_many(smiles, max_degree=99)
    assert len(dc) == len(graphs) == dc.meta["n_mols"]
    assert dc.meta["n_nodes"] == int(dc.atom_counts.sum())
    for i in range(len(dc)):
        _graph_equal(dc[i], graphs[i])
    ids = np.random.RandomState(0).permutation(len(dc))[:100]
    sub = corpus.CorpusSubset(dc, ids)
    assert len(sub) == 100
    for j, g in enumerate(sub):
        _graph_equal(g, graphs[ids[j]])
    assert np.array_equal(sub.atom_counts,
                          [graphs[i].n_atoms for i in ids])
    assert np.array_equal(sub.max_degrees,
                          [graphs[i].max_degree for i in ids])
    jsub = jax_corpus.CorpusSubset(jax_corpus.DiskCorpus(d), ids)
    for tile in (0, 32):
        for sizing in ("total", "max"):
            spec = spec_for_graphs(sub, 16, tile=tile, sizing=sizing)
            assert spec == spec_for_graphs([graphs[i] for i in ids], 16,
                                           tile=tile, sizing=sizing)
            assert dataclasses.asdict(spec) == dataclasses.asdict(
                jax_spec_for_graphs(jsub, 16, tile=tile, sizing=sizing))


@pytest.mark.parametrize("narrow", [False, True])
@pytest.mark.parametrize("tile", [32, 64])
def test_corpus_unit_plan_and_stack_equal_jax(built, narrow, tile):
    """plan_corpus_units gives JAX's id groups and unit spec;
    pack_unit_stack_corpus gives JAX's stack, wide and narrow, and the
    stack pack_unit_stack makes from the same molecules as MolGraphs."""
    _, d = built
    dc = corpus.DiskCorpus(d)
    keep = np.flatnonzero(np.asarray(dc.max_degrees) <= 6)
    assert len(keep) < len(dc)      # the degree-8 carbon of BAD
    ids = keep[np.random.RandomState(1).permutation(len(keep))[:180]]
    sub = corpus.CorpusSubset(dc, ids)
    jsub = jax_corpus.CorpusSubset(jax_corpus.DiskCorpus(d), ids)
    groups, uspec = regroup.plan_corpus_units(sub, tile, seed=5)
    jgroups, juspec = jax_regroup.plan_corpus_units(jsub, tile, seed=5)
    assert dataclasses.asdict(uspec) == dataclasses.asdict(juspec)
    assert len(groups) == len(jgroups)
    for a, b in zip(groups, jgroups):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    wire = regroup.wire_dtypes(uspec) if narrow else None
    stack, uspec2, u = regroup.pack_unit_stack_corpus(sub, tile, seed=5,
                                                      narrow=wire)
    jstack, _, ju = jax_regroup.pack_unit_stack_corpus(jsub, tile, seed=5,
                                                       narrow=wire)
    assert uspec2 == uspec and u == ju == len(groups)
    graphs = [dc[i] for i in ids]
    ref, ruspec, _ = regroup.pack_unit_stack(graphs, tile, seed=5)
    assert ruspec == uspec
    for f in FIELDS:
        assert stack[f].dtype == jstack[f].dtype
        assert np.array_equal(stack[f], jstack[f]), f
        want = np.asarray(getattr(ref, f))
        assert np.array_equal(stack[f], want.astype(wire[f]) if narrow
                              else want), f


def test_corpus_plan_refuses_an_empty_subset_and_a_big_molecule(built):
    _, d = built
    dc = corpus.DiskCorpus(d)
    with pytest.raises(ValueError, match="empty"):
        regroup.plan_corpus_units(corpus.CorpusSubset(dc, []), 32)
    with pytest.raises(ValueError, match="exceeds tile"):
        regroup.plan_corpus_units(corpus.CorpusSubset(dc, range(50)), 4)


def _cfgs(tmp_path, tag, data_path, epochs=1, **kw):
    shared = dict(batch_size=16, epochs=epochs, warm_up=1, aug="none",
                  valid_size=0.1, seed=0, eval_every_epochs=100,
                  save_every_epochs=100, device_cache_mb=512,
                  steps_per_dispatch=1, data_path=data_path)
    shared.update(kw)
    jax_cfg = JaxPretrainConfig(
        featurize_processes=0, ckpt_dir=str(tmp_path / f"j{tag}"),
        model=JaxModelConfig(tile=32, **SMALL), **shared)
    port_cfg = PretrainConfig(ckpt_dir=str(tmp_path / f"p{tag}"),
                              model=ModelConfig(tile=32, **SMALL), **shared)
    return jax_cfg, port_cfg


def test_corpus_pretrainer_matches_jax(tmp_path):
    """From one on-disk corpus, the port's Pretrainer and JAX's take the
    same split ids, spec, unit plan and narrow unit stack (planned from
    the counts, packed from the maps), the same orders, and per-step
    losses within the step-parity limits from JAX's weights (aug
    'none')."""
    d = str(tmp_path / "c.mtpu")
    corpus.build_corpus(iter(_smiles(90, seed=9)), d)
    cfg_j, cfg_p = _cfgs(tmp_path, "u", d)
    ref = JaxPretrainer(cfg_j).setup_data()
    ref.setup_state(next(iter(ref.train_iter))[0])
    ref._build_steps()
    inner, seen = ref._multi_step_units, []

    def recording(state, stack, idxs, rng):
        state, loss = inner(state, stack, idxs, rng)
        seen.append((np.asarray(idxs), np.asarray(loss)))
        return state, loss

    ref._multi_step_units = recording
    params = jax.tree_util.tree_map(np.asarray, ref.state.params)
    stats = jax.tree_util.tree_map(np.asarray, ref.state.batch_stats)
    ref.train(log=lambda *_: None)

    pre = Pretrainer(cfg_p, "cpu").setup_data().setup_state()
    assert isinstance(pre.train_iter.graphs, corpus.CorpusSubset)
    assert np.array_equal(pre.train_iter.graphs.ids,
                          ref.train_iter.graphs.ids)
    assert np.array_equal(pre.valid_iter.graphs.ids,
                          ref.valid_iter.graphs.ids)
    assert dataclasses.asdict(pre.spec) == dataclasses.asdict(ref.spec)
    assert pre.max_waves == ref._max_waves
    assert transfer_state(state_dict_from_jax(params, stats),
                          pre.model)["skipped"] == []
    calls = native.calls["pack_batch_indexed"]
    pre.train(log=lambda *_: None)
    assert pre._units and isinstance(ref._unit_stack, dict)
    assert native.calls["pack_batch_indexed"] - calls == pre._n_units
    assert (pre._n_units, pre._units_per_batch) == (ref._n_units,
                                                    ref._units_per_batch)
    assert (pre._mean_real_edges, pre._mean_real_nodes) == (
        ref._mean_real_edges, ref._mean_real_nodes)
    for f in FIELDS:
        want = np.asarray(ref._unit_stack[f])
        got = pre._stack[f].numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want), f
    s = pre.steps_per_epoch
    assert s >= 3 and len(seen) == s
    orders = regroup.epoch_unit_orders(pre._n_units, pre._units_per_batch,
                                       0, 0)
    for i in range(s):
        assert np.array_equal(seen[i][0][0], orders[i])
    want = np.concatenate([loss for _, loss in seen])
    got = np.concatenate(pre.epoch_losses)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=0.0)
    np.testing.assert_allclose(got[1:], want[1:], rtol=1e-3, atol=2e-5)


def test_streaming_batches_equal_jax_native_superbatches(tmp_path):
    """Above pack_cache_max_mols the host path streams: batch for batch
    over two epochs, the port's narrow wire batches equal those of JAX's
    _native_superbatches (one batch per dispatch), one native indexed
    call per batch, and the first equals the Python pack_batch of the
    same molecules."""
    d = str(tmp_path / "c.mtpu")
    corpus.build_corpus(iter(_smiles(160, seed=13)), d)
    cfg_j, cfg_p = _cfgs(tmp_path, "s", d, aug="node",
                         pack_cache_max_mols=10)
    ref = JaxPretrainer(cfg_j).setup_data()
    pre = Pretrainer(cfg_p, "cpu").setup_data()
    assert not pre.train_iter.cache_packed
    wire = regroup.wire_dtypes(pre.spec)
    assert wire is not None
    for epoch in range(2):
        calls = native.calls["pack_batch_indexed"]
        got = list(pre._stream_batches())
        want = list(ref._native_superbatches(1))
        assert len(got) == len(want) == len(pre.train_iter) > 0
        assert native.calls["pack_batch_indexed"] - calls == len(got)
        for g, w in zip(got, want):
            for f in FIELDS:
                x = np.asarray(w[f])[0]
                assert g[f].dtype == x.dtype == wire[f]
                assert np.array_equal(g[f], x), f
        assert pre.train_iter._epoch == ref.train_iter._epoch == epoch + 1
        if epoch == 0:
            sub = pre.train_iter.graphs
            order = np.random.RandomState(0).permutation(len(sub))
            graphs = [sub[i] for i in order[:16]]
            py = pack_batch(graphs, pre.spec, prefer_native=False)
            for f in FIELDS:
                assert np.array_equal(
                    got[0][f], np.asarray(getattr(py, f)).astype(wire[f]))


def test_add_hs_mismatch_raises(tmp_path):
    """A corpus built without hydrogens refuses aug 'mix', and one built
    with them refuses 'node', with JAX's message."""
    d = str(tmp_path / "c.mtpu")
    corpus.build_corpus(iter(synthetic_corpus(40, seed=1)), d)
    dh = str(tmp_path / "h.mtpu")
    corpus.build_corpus(iter(synthetic_corpus(40, seed=1)), dh, add_hs=True)
    for path, aug in ((d, "mix"), (dh, "node")):
        cfg_j, cfg_p = _cfgs(tmp_path, "m", path, aug=aug)
        with pytest.raises(ValueError) as want:
            JaxPretrainer(cfg_j).setup_data()
        with pytest.raises(ValueError, match="add_hs") as got:
            Pretrainer(cfg_p, "cpu").setup_data()
        assert str(got.value) == str(want.value)


def _text_and_corpus(tmp_path, n=120, add_hs=False):
    text = tmp_path / "corpus.txt"
    text.write_text("".join(s + "\n" for s in _smiles(n, seed=21)))
    d = str(tmp_path / "c.mtpu")
    corpus.build_corpus(corpus_smiles(str(text)), d, add_hs=add_hs)
    return str(text), d


def corpus_smiles(path):
    return port_featurize_cli._smiles_stream(path)


@pytest.mark.parametrize("path", ["units", "stream"])
def test_text_and_corpus_runs_bit_identical(tmp_path, path):
    """The Pretrainer from a SMILES text file and from the corpus built
    from it take the same split, spec and unit stack, and train to the
    same losses, parameters and BatchNorm statistics bit for bit: on the
    units path (node augmentation), and on the host path where the
    corpus streams from the maps and the text file packs in Python."""
    text, d = _text_and_corpus(tmp_path)
    kw = dict(aug="node", epochs=2)
    if path == "stream":
        kw.update(pack_cache_max_mols=10, device_cache_mb=0)
    runs, indexed = [], []
    for src in (text, d):
        _, cfg = _cfgs(tmp_path, f"{path}{len(runs)}", src, **kw)
        pre = Pretrainer(cfg, "cpu").setup_data().setup_state()
        calls = native.calls["pack_batch_indexed"]
        pre.train(log=lambda *_: None)
        indexed.append(native.calls["pack_batch_indexed"] - calls)
        runs.append(pre)
    a, b = runs
    assert isinstance(b.train_iter.graphs, corpus.CorpusSubset)
    assert a.spec == b.spec and a.max_waves == b.max_waves
    assert a._units == b._units == (path == "units")
    assert indexed[0] == 0 and indexed[1] == (
        b._n_units if path == "units" else 2 * len(b.train_iter))
    if path == "units":
        assert a.unit_spec == b.unit_spec
        for f in FIELDS:
            assert torch.equal(a._stack[f], b._stack[f]), f
    for x, y in zip(a.epoch_losses, b.epoch_losses):
        assert np.array_equal(x, y)
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def _run_cli(main, argv, capsys):
    assert main(argv) == 0
    return capsys.readouterr().out.splitlines()


def _untimed(lines):
    """The output lines without the build's seconds and rate."""
    return [ln.split(" in ")[0] if ln.startswith("built ") else ln
            for ln in lines]


@pytest.mark.parametrize("flags", [[], ["--add-hs"], ["--no-native"]])
def test_featurize_cli_matches_jax(tmp_path, capsys, flags):
    """cli.featurize --synthetic N writes the same SMILES file and a
    byte-identical corpus to JAX's, with the same output lines (but the
    timing)."""
    outs = {}
    for who, main in (("port", port_featurize_cli.main),
                      ("jax", jax_featurize_cli.main)):
        root = tmp_path / who
        root.mkdir()
        text, out = str(root / "c.txt"), str(root / "c.mtpu")
        lines = _run_cli(main, [text, out, "--synthetic", "150",
                                "--chunk-size", "64", *flags], capsys)
        outs[who] = ([ln.replace(str(root), "X") for ln in _untimed(lines)],
                     text, out)
    assert outs["port"][0] == outs["jax"][0]
    assert filecmp.cmp(outs["port"][1], outs["jax"][1], shallow=False)
    _same_dir(outs["port"][2], outs["jax"][2])
    meta = corpus.DiskCorpus(outs["port"][2]).meta
    assert meta["add_hs"] == ("--add-hs" in flags)


def test_convert_cli_matches_jax(tmp_path, capsys):
    """cli.convert keeps the rows JAX's keeps, from a CSV with a smiles
    column and from one without a header, with the same output line."""
    smiles = _smiles(40, seed=2)
    with_header = tmp_path / "a.csv"
    with_header.write_text("id,smiles,y\n" + "".join(
        f"{i},{s},{i % 2}\n" for i, s in enumerate(smiles)))
    bare = tmp_path / "b.csv"
    bare.write_text("".join(f"{i},{s}\n" for i, s in enumerate(smiles)))
    for src in (with_header, bare):
        outs = {}
        for who, main in (("port", port_convert_cli.main),
                          ("jax", jax_convert_cli.main)):
            root = tmp_path / f"{src.stem}_{who}"
            root.mkdir()
            out = str(root / "out.txt")
            lines = _run_cli(main, [str(src), out], capsys)
            outs[who] = [ln.replace(str(root), "X") for ln in lines], out
        assert outs["port"][0] == outs["jax"][0]
        assert filecmp.cmp(outs["port"][1], outs["jax"][1], shallow=False)


def test_pretrain_cli_trains_and_resumes_from_a_corpus(tmp_path, capsys):
    """cli.pretrain --data <corpus directory> --cpu trains on the units
    path, stops after epoch 1 of 2 and resumes to the end of its
    schedule."""
    write_pretrain_corpus(str(tmp_path / "c.txt"), 120, seed=0)
    out = str(tmp_path / "c.mtpu")
    port_featurize_cli.main([str(tmp_path / "c.txt"), out])
    cfg = tmp_path / "small.yaml"
    cfg.write_text("batch_size: 16\nepochs: 2\nmodel:\n  num_layer: 2\n"
                   "  emb_dim: 16\n  feat_dim: 32\n  tile: 32\n")
    argv = ["--config", str(cfg), "--data", out, "--cpu", "--ckpt-dir",
            str(tmp_path / "ck"), "--warm-up", "1"]
    capsys.readouterr()
    assert port_pretrain_cli.main(argv + ["--stop-after-epoch", "1"]) == 0
    first = capsys.readouterr().out
    assert "unit stack" in first and "memory-mapped corpus" in first
    assert port_pretrain_cli.main(argv + ["--resume", "latest"]) == 0
    resumed = capsys.readouterr().out
    assert "resumed from" in resumed and "epoch 1:" in resumed
    assert "epoch 0:" not in resumed


def test_no_native_pretrains_in_python(tmp_path, capsys):
    """Pretrainer(prefer_native=False), cli.pretrain --no-native,
    featurizes a SMILES file in featurize_processes (dataset.num_workers)
    spawned processes and packs in Python, with no native call, and trains
    bit for bit as the native run does; an on-disk corpus refuses it."""
    text, d = _text_and_corpus(tmp_path, n=80)
    runs = []
    for prefer in (True, False):
        _, cfg = _cfgs(tmp_path, f"n{prefer}", text, aug="node")
        cfg.featurize_processes = 2
        before = dict(native.calls)
        pre = Pretrainer(cfg, "cpu", prefer_native=prefer).setup_data()
        pre.setup_state().train(log=lambda *_: None)
        assert (native.calls == before) == (not prefer)
        runs.append(pre)
    a, b = runs
    assert a._units and b._units and a.spec == b.spec
    for f in FIELDS:
        assert torch.equal(a._stack[f], b._stack[f]), f
    for x, y in zip(a.epoch_losses, b.epoch_losses):
        assert np.array_equal(x, y)
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k

    cfg = tmp_path / "small.yaml"
    cfg.write_text("batch_size: 16\nepochs: 1\ndataset:\n  num_workers: 2\n"
                   "model:\n  num_layer: 2\n  emb_dim: 16\n  feat_dim: 32\n"
                   "  tile: 32\n")
    argv = ["--config", str(cfg), "--cpu", "--no-native", "--warm-up", "1",
            "--ckpt-dir", str(tmp_path / "ck")]
    before = dict(native.calls)
    assert port_pretrain_cli.main(argv + ["--data", text]) == 0
    assert native.calls == before
    assert "epoch 0:" in capsys.readouterr().out
    with pytest.raises(ValueError, match="--no-native"):
        port_pretrain_cli.main(argv + ["--data", d])

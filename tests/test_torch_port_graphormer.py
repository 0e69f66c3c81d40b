"""The Graphormer network (models/graphormer.py) and its host data
(data/graphormer.py) against the plain per-molecule reference
(tests/graphormer_reference.py), at a small size on the CPU: 2 layers of
width 48, 4 heads, 5 hops, tile 64, molecules with hydrogens.

Tolerances. Program and reference compute the same f32 arithmetic in
another order (the program's tile-wide products, the hop tables projected
before their gather, the attention's backward by hand), so single values
agree to a few f32 roundings carried through 2 layers: logits and losses
within 1e-5 of their scale, each parameter's gradient within 1e-4 of its
largest entry or, where that is below the median parameter's (the keys'
biases, whose gradient is zero but for rounding: a softmax ignores a
constant added to a row), of the median parameter's; each parameter's
change over three Adam steps within 1e-4 of its norm (Adam divides by the
root of the second moment, so a gradient entry near zero moves its update
by more than its own rounding; the keys' biases, which Adam moves by the
rounding's sign alone, are left out with every parameter whose gradient
is below 1e-3 of the median's).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import graphormer_reference as gref
from molclr_tpu_torch.data.featurize import featurize_smiles
from molclr_tpu_torch.data.graphormer import bond_ids, pair_tables, \
    tile_pairs, with_graph_token
from molclr_tpu_torch.data.graphs import GraphBatch, pack_batch
from molclr_tpu_torch.data.loader import spec_for_graphs
from molclr_tpu_torch.models import GraphormerNet
from molclr_tpu_torch.train.config import GRAPHORMER_BASE, FineTuneConfig, \
    ModelConfig, finetune_from_yaml
from molclr_tpu_torch.train.finetune import FineTuner, compute_loss

LAYERS, D, HEADS, HOPS, TILE, DROP = 2, 48, 4, 5, 64, 0.1
SMILES = [
    "c1ccc2ccccc2c1",                    # naphthalene: fused rings, ties
    "C1CC2CCC3CCCC3C2C1",                # three fused rings
    "OC(=O)c1ccccc1.N",                  # a salt: unreachable pairs
    "CC(=O)Nc1ccc(O)cc1",
    "C1CCC2(CC1)CCCC2",                  # a spiro centre
]
FW_RULE_SMILES = SMILES + ["c1ccc2c(c1)ccc1ccccc12", "CCOC(=O)C1CCN(C)CC1",
                           "Cc1ccc(S(=O)(=O)N)cc1.[Na+].[Cl-]"]


def _graphs(smiles):
    return [featurize_smiles(s, add_hs=True) for s in smiles]


def _net(seed=0, drop=DROP):
    return GraphormerNet(num_layers=LAYERS, emb_dim=D, ffn_dim=D,
                         num_heads=HEADS, max_hops=HOPS, drop_ratio=drop,
                         tile=TILE, generator=torch.Generator().manual_seed(
                             seed))


def _perturbed(net, seed):
    """The network's parameters moved by a seeded draw, so that the bias
    tables (which start near zero) move the scores."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in net.named_parameters():
            scale = 0.5 if "embedding" in name or "graph_token" in name \
                or "hop" in name else 0.05
            p.add_(scale * torch.randn(p.shape, generator=g))
    return net


def _packed(smiles):
    """(GraphBatch of tensors, spatial, path, reference batch dict)."""
    graphs = _graphs(smiles)
    tables = pair_tables(graphs, HOPS)
    tok = [with_graph_token(g) for g in graphs]
    spec = dataclasses.replace(spec_for_graphs(tok, len(tok), tile=TILE),
                               n_graphs=len(tok) + 1)
    b = pack_batch(tok, spec)
    sp, pa = tile_pairs(b, tables, TILE, HOPS)
    batch = b.to("cpu")
    ref = {f.name: getattr(batch, f.name) for f in
           dataclasses.fields(GraphBatch)}
    return batch, torch.from_numpy(sp), torch.from_numpy(pa), ref


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


@pytest.mark.parametrize("smiles", FW_RULE_SMILES)
def test_pair_tables_match_bfs_and_the_path_rule(smiles):
    """Distances equal breadth-first search's; each hop's bond id is that
    of the reference's Floyd-Warshall recursion (the same tie rule by
    another implementation), the spatial row distance + 1 or 511."""
    g = _graphs([smiles])[0]
    (spatial, path), = pair_tables([g], HOPS)
    n = g.n_atoms
    bonds = sorted({(min(int(s), int(d)), max(int(s), int(d)), int(t),
                     int(r)) for s, d, t, r in zip(g.edge_src, g.edge_dst,
                                                   g.bond_type, g.bond_dir)})
    dist, types, dirs, real = gref.shortest_paths(n, bonds, HOPS)
    assert dist.tolist() == gref.bfs_distances(n, bonds)
    want = torch.where(dist >= gref.UNREACHABLE, 511, dist + 1)
    assert np.array_equal(spatial, want.numpy())
    ids = torch.where(real, 1 + types * 3 + dirs, 0)
    assert np.array_equal(path, ids.numpy())
    # every hop a bond of the molecule, chained from i along the path
    assert set(np.unique(path)) <= {0} | set(bond_ids(g).tolist())
    hops = (path > 0).sum(-1)
    assert np.array_equal(hops, np.where(dist.numpy() >= 510, 0,
                                         np.minimum(dist.numpy(), HOPS)))


def test_ties_and_salts_are_present():
    """The cases above hold ties (pairs joined by two shortest paths) and
    unreachable pairs, so the rule and the 511 row are exercised."""
    g = _graphs(["c1ccc2ccccc2c1"])[0]
    dist = np.array(gref.bfs_distances(g.n_atoms, [
        (int(s), int(d), 0, 0) for s, d in zip(g.edge_src, g.edge_dst)]))
    adj = np.zeros((g.n_atoms, g.n_atoms), int)
    adj[g.edge_src, g.edge_dst] = 1
    # shortest paths counted by dynamic programming over distance levels
    ways = (dist == 0).astype(int)
    for d in range(1, dist.max() + 1):
        ways = np.where(dist == d, (ways * (dist == d - 1)) @ adj, ways)
    assert (ways > 1).any()
    (spatial, _), = pair_tables(_graphs(["OC(=O)c1ccccc1.N"]), HOPS)
    assert (spatial == 511).any()


@pytest.mark.parametrize("training", [False, True])
def test_forward_loss_and_gradients_match_the_reference(training):
    """Logits of every molecule, the loss and every parameter's gradient
    against the reference, in evaluation and in training with the
    program's keep masks."""
    net = _perturbed(_net(), 1)
    net.train(training)
    batch, sp, pa, ref = _packed(SMILES)
    keep = (net.keep_masks(batch.num_nodes,
                           torch.Generator().manual_seed(5))
            if training else None)
    labels = torch.tensor([0, 1, 1, 0, 1, 0], dtype=torch.float32)
    _, pred = net(batch, sp, pa, dropout_masks=keep)
    loss = compute_loss(pred, labels, batch.graph_mask, "ce")
    loss.backward()
    p0 = {k: v.detach() for k, v in net.named_parameters()}
    got = gref.finetune_steps(p0, [ref], [labels], [keep],
                              layers=LAYERS, heads=HEADS, hops=HOPS,
                              tile=TILE, drop=DROP if training else 0.0,
                              head_lr=0.0, base_lr=0.0, wd=0.0,
                              device="cpu")
    assert abs(float(loss.detach()) - got["losses"][0]) \
        <= 1e-5 * abs(got["losses"][0])
    scale = {k: float(g.abs().max()) for k, g in got["first_grad"].items()}
    median = sorted(scale.values())[len(scale) // 2]
    for name, p in net.named_parameters():
        gap = float((p.grad - got["first_grad"][name]).abs().max())
        assert gap <= 1e-4 * max(scale[name], median), name
    if not training:
        want = gref.predict(p0, [ref], layers=LAYERS, heads=HEADS,
                            hops=HOPS, device="cpu")[0]
        real = batch.graph_mask
        assert _rel(pred.detach()[real], want[real]) <= 1e-5


def test_molecules_in_a_tile_are_isolated_and_padding_is_inert():
    """Changing one molecule's atoms (or what the padding rows hold)
    leaves every other molecule's output bit for bit."""
    net = _perturbed(_net(), 2).eval()
    batch, sp, pa, _ = _packed(SMILES)
    with torch.no_grad():
        base = net(batch, sp, pa)[1]
        rows = (batch.node_graph == 3) & batch.node_mask \
            & (batch.atom_type != 119)
        changed = dataclasses.replace(
            batch, atom_type=torch.where(rows, 6, batch.atom_type))
        other = net(changed, sp, pa)[1]
        pad = ~batch.node_mask
        padded = dataclasses.replace(
            batch, atom_type=torch.where(pad, 7, batch.atom_type),
            chirality=torch.where(pad, 2, batch.chirality),
            node_graph=torch.where(pad, 3, batch.node_graph))
        again = net(padded, sp, pa)[1]
    real = batch.graph_mask.clone()
    assert not torch.equal(base[3], other[3])
    real[3] = False
    assert torch.equal(base[real], other[real])
    assert torch.equal(base[batch.graph_mask], again[batch.graph_mask])
    # the molecules share tiles
    tiles = torch.nonzero(batch.atom_type == 119)[:, 0] // TILE
    assert tiles.unique().numel() < tiles.numel()


def _finetuner(tmp_path, **model):
    model = dict(gnn_type="graphormer", num_layers=LAYERS, emb_dim=D,
                 ffn_dim=D, num_heads=HEADS, max_hops=HOPS, drop_ratio=DROP,
                 tile=TILE, **model)
    cfg = FineTuneConfig(task_name="HIV", data_root=str(tmp_path / "data"),
                         synthetic_fallback=True, synthetic_n=120,
                         batch_size=16, epochs=1, init_lr=1e-3,
                         init_base_lr=5e-4, ckpt_dir=str(tmp_path / "ck"),
                         model=ModelConfig(**model))
    with pytest.warns(UserWarning, match="SYNTHETIC"):
        ft = FineTuner(cfg, "cpu").setup_data()
    return ft.setup_state()


def test_finetuner_steps_match_the_reference(tmp_path):
    """Three FineTuner steps (dropout from the seed's generator, the
    two-group Adam) against the reference given the program's keep masks
    (re-drawn from a generator in the same state) and its batches."""
    ft = _finetuner(tmp_path)
    p0 = {k: v.detach().clone() for k, v in ft.model.named_parameters()}
    stack, order = ft._train_epoch_stack()
    rows = torch.from_numpy(np.asarray(order, np.int64)[:3, None])
    gen = torch.Generator().manual_seed(ft.cfg.seed + 17)
    batches, labels, keeps = [], [], []
    for r in rows:
        b, lab, _ = ft._take(stack, r)
        batches.append({f.name: getattr(b, f.name)
                        for f in dataclasses.fields(GraphBatch)})
        labels.append(lab)
        keeps.append(ft.model.keep_masks(b.num_nodes, gen))
    losses = ft._run_steps(rows)[:, 0].tolist()
    cfg = ft.cfg
    want = gref.finetune_steps(p0, batches, labels, keeps, layers=LAYERS,
                               heads=HEADS, hops=HOPS, tile=TILE, drop=DROP,
                               head_lr=cfg.init_lr, base_lr=cfg.init_base_lr,
                               wd=cfg.weight_decay, device="cpu")
    for a, b in zip(losses, want["losses"]):
        assert abs(a - b) <= 1e-5 * abs(b)
    # leaves whose first gradient is below 1e-3 of the median leaf's (the
    # keys' biases, zero but for rounding; the hop tables at this init)
    # take Adam steps of the rounding's sign on either side: left out, as
    # the benchmark's comparison leaves them out (their gradients are held
    # to the reference's above)
    scale = {k: float(g.abs().max()) for k, g in want["first_grad"].items()}
    median = sorted(scale.values())[len(scale) // 2]
    for name, p in ft.model.named_parameters():
        if scale[name] < 1e-3 * median:
            continue
        moved = want["params"][name] - p0[name]
        gap = p.detach() - want["params"][name]
        assert float(gap.norm()) <= 1e-4 * float(moved.norm()), name


def test_finetuner_records_the_pair_counters(tmp_path):
    """train()'s record carries the pairs the molecules need (sum of
    (atoms + 1)^2) and those the tile attention computes (T tile^2 a
    step), from the train stack that the epoch ran."""
    ft = _finetuner(tmp_path)
    out = ft.train(log=lambda *_: None)
    rec = out["history"][0]
    stack = ft._stacks["train"]
    n = stack.batches["graph_n_nodes"].long()
    assert rec["pairs_real"] == int((n ** 2).sum())
    assert rec["pairs_computed"] == stack.extras["spatial"].numel()
    assert rec["pairs_real"] < rec["pairs_computed"]
    assert stack.extras["path"].shape[-1] == HOPS


def test_cli_model_graphormer_reaches_the_finetuner(tmp_path, monkeypatch):
    """--model graphormer trains Graphormer-base (12 x 768, 32 heads, 5
    hops) through FineTuner; the YAML reader takes Graphormer's keys."""
    from molclr_tpu_torch.cli import finetune as cli

    built = []

    class Recording(FineTuner):
        def setup_state(self):
            built.append(dataclasses.asdict(self.cfg.model))
            raise SystemExit(0)

    monkeypatch.setattr("molclr_tpu_torch.train.finetune.FineTuner",
                        Recording)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit), pytest.warns(UserWarning):
        cli.main(["--task", "HIV", "--model", "graphormer", "--cpu",
                  "--allow-synthetic", "--data-root", str(tmp_path),
                  "--config", str(tmp_path / "none.yaml")])
    assert {k: built[0][k] for k in GRAPHORMER_BASE} == GRAPHORMER_BASE
    yaml = tmp_path / "g.yaml"
    yaml.write_text("model_type: graphormer\nmodel:\n  num_layer: 2\n"
                    "  emb_dim: 48\n  num_heads: 4\n  ffn_dim: 64\n"
                    "  max_hops: 3\n")
    m = finetune_from_yaml(str(yaml)).model
    assert (m.gnn_type, m.num_layers, m.emb_dim, m.num_heads, m.ffn_dim,
            m.max_hops) == ("graphormer", 2, 48, 4, 64, 3)


def test_benchmark_copy_of_the_reference_is_the_same():
    """benchmark/reference/graphormer.py is this reference, line for
    line."""
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "graphormer_reference.py")) as f:
        a = f.read()
    with open(os.path.join(here, "..", "benchmark", "reference",
                           "graphormer.py")) as f:
        b = f.read()
    assert a == b

"""The plain reference against the port's plain CPU path at a tiny size:
the augmentations view for view, then every cell's run (set-up, window,
the checked steps against the reference) comes out correct."""

import numpy as np
import pytest
import torch

from benchmark.reference import data as rdata
from benchmark.tests import tiny
from benchmark.traffic import molgen
from molclr_tpu_torch.data.augment import draw_paired_keys, \
    paired_augment_keys
from molclr_tpu_torch.data.graphs import pack_batch
from molclr_tpu_torch.data.loader import featurize_many, spec_for_graphs

from benchmark.tests.test_bench_generator import PARAMS


def packed(n=40, seed=3):
    smiles, _, _ = molgen.generate(n, seed, PARAMS)
    graphs, _ = featurize_many(smiles, prefer_native=False)
    spec = spec_for_graphs(graphs, n, tile=128)
    return pack_batch(graphs, spec).to("cpu"), spec


@pytest.mark.parametrize("kind", ["node", "subgraph"])
def test_views_match_the_port(kind):
    batch, spec = packed()
    waves = int(batch.graph_n_nodes.max()) - 1
    keys = draw_paired_keys(kind, batch.num_nodes, batch.num_graphs,
                            torch.Generator().manual_seed(11))
    mine = rdata.draw_keys(kind, batch.num_nodes,
                           torch.Generator().manual_seed(11))
    port = paired_augment_keys(batch, keys, kind, tile=128,
                               bond_window=spec.max_graph_bonds,
                               max_waves=waves)
    b = {f: getattr(batch, f) for f in rdata.FIELDS}
    ref = rdata.paired_views(b, kind, mine, waves)
    for p, r in zip(port, ref):
        assert torch.equal(p.atom_type, r["atom_type"])
        assert torch.equal(p.chirality, r["chirality"])
        assert torch.equal(p.edge_mask, r["edge_mask"])
    assert int((port[0].atom_type == rdata.MASK_ATOM_TYPE).sum()) > 0


def test_unit_plan_matches_the_port():
    from molclr_tpu_torch.data.regroup import epoch_unit_orders, \
        plan_unit_groups

    smiles, sig, _ = molgen.generate(300, 4, PARAMS)
    graphs, _ = featurize_many(smiles, prefer_native=False)
    groups, _ = plan_unit_groups(graphs, 128, seed=5)
    mine = rdata.unit_groups(sig[:, 7], 128, 5)
    ids = {id(g): i for i, g in enumerate(graphs)}
    assert [[ids[id(g)] for g in gr] for gr in groups] == \
        [list(m) for m in mine]
    assert np.array_equal(epoch_unit_orders(len(groups), 3, 5, 2)[:4],
                          rdata.epoch_orders(len(mine), 3, 5, 2, 4))


@pytest.mark.parametrize("cell", ["gin.pretrain_node_b512",
                                  "gcn.pretrain_node_b512",
                                  "gin.pretrain_subgraph_b512",
                                  "gin.finetune_clintox_m6"])
def test_cell_correct_on_the_cpu(cell):
    result = tiny.run(cell)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    e2e = result["metrics"]
    assert e2e["setup_s"]["value"] > 0
    assert all(v["value"] > 0 for v in e2e.values())


def test_traced_run_reads_its_metrics():
    result = tiny.run("gin.pretrain_node_b512", trace=True)
    assert result["correct"]
    assert "step_mfu.pretrain" in result["metrics"]
    assert result["device"]["window_s"] > 0
    assert "breakdown" in result

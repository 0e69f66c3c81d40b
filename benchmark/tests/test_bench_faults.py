"""A run with the timed path broken underneath comes out not correct:
for each fault a training cell can have (the step leaves its state
unchanged; half of the batch left out of the loss, its mean taken over
the rest; an answer altered where it is produced). One card, so there is
no exchange between chips to leave out."""

import dataclasses

import pytest
import torch

from benchmark.tests import tiny
from molclr_tpu_torch.train import finetune as ft_mod
from molclr_tpu_torch.train import pretrain as pt_mod


def _half(mask):
    rank = torch.cumsum(mask.long(), 0) - 1
    return mask & (rank < int(mask.sum()) // 2)


def state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)


def pretrain_half(monkeypatch):
    orig = pt_mod._loss

    def loss(loss_fn, cfg, zi, zj, batch, dp=None):
        return orig(loss_fn, cfg, zi, zj, dataclasses.replace(
            batch, graph_mask=_half(batch.graph_mask)), dp)

    monkeypatch.setattr(pt_mod, "_loss", loss)


def pretrain_altered(monkeypatch):
    orig = pt_mod.paired_augment_keys

    def views(batch, *a, **k):
        vi, vj = orig(batch, *a, **k)
        at = vi.atom_type.clone()
        first = int(torch.nonzero(vi.node_mask)[0])
        at[first] = (at[first] + 1) % 118
        return dataclasses.replace(vi, atom_type=at), vj

    monkeypatch.setattr(pt_mod, "paired_augment_keys", views)


def finetune_half(monkeypatch):
    orig = ft_mod.compute_loss
    monkeypatch.setattr(ft_mod, "compute_loss",
                        lambda pred, labels, mask, loss: orig(
                            pred, labels, _half(mask), loss))


def finetune_altered(monkeypatch):
    orig = ft_mod.predict
    monkeypatch.setattr(ft_mod, "predict",
                        lambda *a: orig(*a) * 1.001)


@pytest.mark.parametrize("cell,fault", [
    ("gin.pretrain_node_b512", state_unchanged),
    ("gin.pretrain_node_b512", pretrain_half),
    ("gin.pretrain_node_b512", pretrain_altered),
    ("gin.pretrain_subgraph_b512", pretrain_altered),
    ("gin.finetune_clintox_m6", state_unchanged),
    ("gin.finetune_clintox_m6", finetune_half),
    ("gin.finetune_clintox_m6", finetune_altered),
], ids=lambda x: x if isinstance(x, str) else x.__name__)
def test_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    assert not tiny.run(cell)["correct"]


@pytest.mark.parametrize("cell", ["gin.pretrain_node_b512",
                                  "gin.finetune_clintox_m6"])
def test_control_script_reads_each_side(cell):
    from benchmark import control

    config, traffic, _ = tiny.shrunk(cell)
    lines = control.readings(cell, [5], torch.device("cpu"), config,
                             traffic)
    seed, summary = lines
    assert set(seed["control"]) == {"tf32", "half", "frozen"}
    assert seed["control"]["frozen"]["update_norm_gap"] == 1.0
    assert seed["control"]["half"]["loss0_gap"] > 1e-3
    assert summary["program_max"]["loss0_gap"] < 1e-5
    # each side judged against the cell's limits as a run is
    assert seed["correct"]["program"]
    assert not seed["correct"]["half"] and not seed["correct"]["frozen"]
    assert summary["correct_on_seeds"]["half"] == []

"""Tiny CPU versions of the cells for the tests: the cells' own files with
the widths, the corpus and the batch shrunk so that a run takes seconds
on the kernels' plain versions."""

import time

import torch

from benchmark import harness

PRETRAIN = dict(emb_dim=16, feat_dim=32, num_layer=2, tile=128,
                pretrain_corpus_molecules=800)
FINETUNE = dict(emb_dim=16, feat_dim=32, num_layer=2)


def shrunk(cell: str):
    """(config, traffic, limits) of `cell` at the tests' size."""
    _, _, config, traffic, limits = harness.load_cell(cell)
    if traffic["loop"] == "pretrain":
        return (dict(config, **PRETRAIN), dict(traffic, batch_size=32),
                limits)
    return dict(config, **FINETUNE), dict(traffic, molecules_total=300), \
        limits


def run(cell: str, seed: int = 2**31 + 77, trace: bool = False) -> dict:
    config, traffic, limits = shrunk(cell)
    return harness.run_cell(cell, seed, 0.5, trace, torch.device("cpu"),
                            time.perf_counter(), config=config,
                            traffic=traffic, limits=limits)

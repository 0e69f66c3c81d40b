"""Motif (clique) vocabulary pipeline for the fine-tune motif head.

Mirrors the reference's _gen_cliques + motif-embedding initialization flow
(ref finetune.py:104-161):

  1. BRICS-decompose every molecule in the dataset (utils/clique.py:11-90
     via molclr_tpu_torch.chem.brics) and canonicalize each fragment to a
     SMILES key.
  2. Build the global motif vocabulary and each molecule's motif multiset.
  3. Encode every vocabulary fragment once with the (pretrained) plain
     encoder; the stacked features seed the motif embedding table
     (finetune.py:144-161, ginet_finetune_mp.py:137-139).

Port of molclr_tpu/data/motifs.py: the vocabulary code is a copy; the
encoder of step 3 is the port's FineTuneNet.

The per-batch CPU index-building the reference does inside the hot loop
(finetune.py:202-210, an O(B*cliques*|vocab|) list.index scan per step) is
replaced by precomputed padded [n_mols, C_max] id/mask arrays sliced per
batch.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from molclr_tpu_torch.chem.brics import brics_decompose, clique_mol_smiles
from molclr_tpu_torch.chem.smiles import parse_smiles


@dataclass
class MotifVocab:
    smiles: list[str]              # vocabulary fragment keys, index = id
    mol_motifs: np.ndarray         # int32 [n_mols, c_max], padded with 0
    mol_motif_mask: np.ndarray     # bool  [n_mols, c_max]

    @property
    def size(self) -> int:
        return len(self.smiles)

    @property
    def c_max(self) -> int:
        return self.mol_motifs.shape[1]


def mol_fragment_keys(smiles: str) -> list[str]:
    """Canonical-SMILES keys of one molecule's BRICS fragments, sorted
    largest-first (the expensive per-molecule decomposition step; cacheable
    across a multi-target task's columns)."""
    mol = parse_smiles(smiles, strict=False)
    if mol is None or mol.num_atoms == 0:
        return []
    cliques, _ = brics_decompose(mol)
    cliques.sort(key=len, reverse=True)
    return [clique_mol_smiles(mol, atoms) for atoms in cliques]


def build_motif_vocab(smiles_list: list[str],
                      max_motifs_per_mol: int = 12,
                      fragment_keys: list[list[str]] | None = None) \
        -> MotifVocab:
    """Decompose all molecules and build the vocabulary + per-molecule motif
    id arrays (ref finetune.py:104-119). Molecules with more motifs than
    max_motifs_per_mol keep their largest-first prefix.

    `fragment_keys`: optional precomputed mol_fragment_keys per molecule
    (aligned with smiles_list) — multi-target tasks decompose each
    molecule once and reuse across target columns."""
    vocab: dict[str, int] = {}
    per_mol: list[list[int]] = []
    for mi, s in enumerate(smiles_list):
        if fragment_keys is not None:
            keys = fragment_keys[mi][:max_motifs_per_mol]
        else:
            keys = mol_fragment_keys(s)[:max_motifs_per_mol]
        ids: list[int] = []
        for key in keys:
            if key not in vocab:
                vocab[key] = len(vocab)
            ids.append(vocab[key])
        per_mol.append(ids)

    c_max = max(1, max((len(x) for x in per_mol), default=1))
    n = len(per_mol)
    mol_motifs = np.zeros((n, c_max), np.int32)
    mask = np.zeros((n, c_max), bool)
    for i, ids in enumerate(per_mol):
        mol_motifs[i, : len(ids)] = ids
        mask[i, : len(ids)] = True
    keys = [k for k, _ in sorted(vocab.items(), key=lambda kv: kv[1])]
    return MotifVocab(smiles=keys, mol_motifs=mol_motifs,
                      mol_motif_mask=mask)


def encode_motif_vocab(vocab: MotifVocab, model, feat_dim: int,
                       batch_size: int = 64, max_degree: int = 6,
                       tile: int = 0) -> np.ndarray:
    """Encode every vocabulary fragment with the plain encoder `model` (a
    FineTuneNet, in eval mode on its own device); rows for unparseable
    fragments stay zero (ref finetune.py:144-156 encodes clique graphs with
    the plain fine-tune GINet and stacks h)."""
    import torch

    from molclr_tpu_torch.data.featurize import featurize_smiles
    from molclr_tpu_torch.data.graphs import pack_batch
    from molclr_tpu_torch.data.loader import spec_for_graphs

    out = np.zeros((vocab.size, feat_dim), np.float32)
    graphs, kept = [], []
    for i, s in enumerate(vocab.smiles):
        g = featurize_smiles(s)
        if g is not None and (g.n_atoms == 0 or g.max_degree <= max_degree):
            graphs.append(g)
            kept.append(i)
    if not graphs:
        return out
    spec = spec_for_graphs(graphs, min(batch_size, len(graphs)),
                           max_degree=max_degree,
                           tile=getattr(model, "tile", 0) or tile,
                           sizing="max")
    device = next(model.parameters()).device
    was_training = model.training
    model.eval()
    with torch.no_grad():
        for lo in range(0, len(graphs), spec.n_graphs):
            chunk = graphs[lo : lo + spec.n_graphs]
            h, _ = model(pack_batch(chunk, spec).to(device))
            h = h.float().cpu().numpy()
            for j, gi in enumerate(kept[lo : lo + spec.n_graphs]):
                out[gi] = h[j]
    model.train(was_training)
    return out

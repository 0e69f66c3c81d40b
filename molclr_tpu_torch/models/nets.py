"""Encoder trunk and the pretraining network, BN-chained fused path.

Port of molclr_tpu/models/nets.py (`GNNTrunk`'s BN-chained path and
`MolCLRNet`). Shapes and semantics follow the reference:
  trunk   h = Emb_type(x0) + Emb_chir(x1); num_layer x [conv -> BN ->
          relu] with no relu after the last BN; mean pool; feat_lin
          (ginet_molclr.py:98-114, gcn_molclr.py:139-155)
  MolCLR  projection head feat -> feat -> relu -> feat/2, returns (h, z)
          (ginet_molclr.py:92-96,117)
The state-dict keys are the reference's (x_embedding1/2, gnns.{i}.*,
batch_norms.{i}.*, feat_lin, out_lin.{0,2}), so a reference .pth loads
directly.

Every conv layer runs as one fused kernel call that applies the previous
BatchNorm's affine + relu as its prologue and returns its masked output
moments; MaskedBatchNorm turns those into the next affine, and the last
layer's affine and mask run here. The JAX package runs this path whenever
fused=True, tile > 0 and drop_ratio == 0 (in eval mode too); its tests hold
it to the unfused path. In train mode gradients flow through the GINE
kernels' backward (K1b) and through the BatchNorm coefficient math; the
GCN layer's backward kernel is not ported, so GCN training runs on the
CPU only.
"""

from __future__ import annotations

import torch
from torch import nn

from molclr_tpu_torch.data.featurize import (
    NUM_ATOM_TYPES,
    NUM_BOND_DIRS,
    NUM_BOND_TYPES,
    NUM_CHIRALITY,
)
from molclr_tpu_torch.models.layers import (
    GCNConv,
    GINEConv,
    MaskedBatchNorm,
    reset_linear_,
    xavier_uniform_,
)
from molclr_tpu_torch.ops.fused_layer import pack_cnt
from molclr_tpu_torch.ops.scatter_free import _counts, embed_lookup
from molclr_tpu_torch.ops.segment import graph_pool
from molclr_tpu_torch.ops.tile_dense import build_tile_adjacency


class MolCLRNet(nn.Module):
    """Pretraining network: trunk + pool + feat_lin + projection head.

    dtype is the activation dtype of the trunk (f32 or bf16); parameters
    stay f32. Initial weights come from `generator` (a torch.Generator on
    the CPU); build the model on the CPU and move it with .to(device).
    Options of the JAX model that the port does not have yet raise
    NotImplementedError: tile == 0 (the ELL gather path), normalize_gcn
    and drop_ratio > 0 (the unchained fused path)."""

    def __init__(self, num_layers: int = 5, emb_dim: int = 300,
                 feat_dim: int = 512, gnn_type: str = "gin",
                 pool: str = "mean", drop_ratio: float = 0.0,
                 normalize_gcn: bool = False, dtype=torch.float32,
                 tile: int = 256, generator: torch.Generator | None = None):
        super().__init__()
        if gnn_type not in ("gin", "gcn"):
            raise ValueError(f"unknown gnn_type {gnn_type!r}")
        if tile <= 0:
            raise NotImplementedError("tile == 0 (ELL gather path) is not "
                                      "ported yet")
        if normalize_gcn:
            raise NotImplementedError("normalize_gcn is not ported yet")
        if drop_ratio > 0:
            raise NotImplementedError("drop_ratio > 0 (unchained fused "
                                      "path) is not ported yet")
        self.num_layers, self.emb_dim, self.feat_dim = \
            num_layers, emb_dim, feat_dim
        self.gnn_type, self.pool, self.dtype, self.tile = \
            gnn_type, pool, dtype, tile
        g = generator
        self.x_embedding1 = nn.Embedding(NUM_ATOM_TYPES, emb_dim)
        self.x_embedding2 = nn.Embedding(NUM_CHIRALITY, emb_dim)
        xavier_uniform_(self.x_embedding1.weight, g)
        xavier_uniform_(self.x_embedding2.weight, g)
        conv = GINEConv if gnn_type == "gin" else GCNConv
        self.gnns = nn.ModuleList(conv(emb_dim, g) for _ in range(num_layers))
        self.batch_norms = nn.ModuleList(
            MaskedBatchNorm(emb_dim) for _ in range(num_layers))
        self.feat_lin = reset_linear_(nn.Linear(emb_dim, feat_dim), g)
        self.out_lin = nn.Sequential(
            reset_linear_(nn.Linear(feat_dim, feat_dim), g), nn.ReLU(),
            reset_linear_(nn.Linear(feat_dim, feat_dim // 2), g))

    def trunk(self, batch) -> torch.Tensor:
        """Node embeddings [N, emb_dim] in the activation dtype."""
        dt = self.dtype
        mask = batch.node_mask[:, None]
        h = (embed_lookup(self.x_embedding1.weight, batch.atom_type)
             + embed_lookup(self.x_embedding2.weight, batch.chirality))
        h = torch.where(mask, h.to(dt), 0)
        adj = build_tile_adjacency(batch.nbr, batch.nbr_mask, self.tile,
                                   dtype=dt)
        w = batch.nbr_mask.to(dt)
        cnt = pack_cnt(_counts(batch.nbr_bond_type, w, NUM_BOND_TYPES),
                       _counts(batch.nbr_bond_dir, w, NUM_BOND_DIRS))
        count = batch.node_mask.float().sum()
        d = self.emb_dim
        a = torch.ones(d, device=h.device)
        b = torch.zeros(d, device=h.device)
        relu_in = False
        for layer, (conv, bn) in enumerate(zip(self.gnns, self.batch_norms)):
            out, sums = conv(h, adj, cnt, (a, b, relu_in))
            a, b = bn((sums[0], sums[1], count))
            if layer == self.num_layers - 1:
                h = torch.where(mask, out * a.to(dt) + b.to(dt), 0)
            else:
                h, relu_in = out, True
        return h

    def forward(self, batch):
        """batch: a GraphBatch of tensors on the model's device. Returns
        (h [G, feat_dim], z [G, feat_dim // 2])."""
        h = self.trunk(batch)
        hg = graph_pool(h, batch.node_graph, batch.node_mask,
                        batch.num_graphs, batch.graph_n_nodes, self.pool)
        cd = self.dtype
        hg = _linear(self.feat_lin, hg, cd)
        z = torch.relu(_linear(self.out_lin[0], hg, cd))
        return hg, _linear(self.out_lin[2], z, cd)


def _linear(lin: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    """Dense layer computed in `dtype` with f32 parameters cast to it (the
    JAX package's dense(dtype=...) semantics)."""
    return nn.functional.linear(x.to(dtype), lin.weight.to(dtype),
                                lin.bias.to(dtype))

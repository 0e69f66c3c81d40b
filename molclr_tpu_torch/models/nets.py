"""Encoder trunk, the pretraining network and the fine-tune networks.

Port of molclr_tpu/models/nets.py (`GNNTrunk` on its two fused paths and
its ELL path, `MolCLRNet`, `_pred_head`, `FineTuneNet`, `LinkFineTuneNet`,
`MotifFineTuneNet`). Shapes and semantics follow the reference:
  trunk    h = Emb_type(x0) + Emb_chir(x1); num_layer x [conv -> BN ->
           dropout(relu)] with no relu after the last BN; mean pool;
           feat_lin (ginet_molclr.py:98-114, gcn_molclr.py:139-155)
  MolCLR   projection head feat -> feat -> relu -> feat/2, returns (h, z)
           (ginet_molclr.py:92-96,117)
  FineTune pred head feat -> feat/2 -> act [x pred_n_layer] -> out_dim, out
           dim 2 (classification logits) or 1 (ginet_finetune.py:96-127)
  Link     label_embedding [2, feat] ~ N(0, 1), label_lin (feat -> feat);
           one pred head on cat(h, label_lin(label_embedding)[y]) [2 feat]
           -> 1 for each label y, out [G, 2] (ginet_finetune_link.py:52-162)
  Motif    motif_embedding(num_motifs, feat); attention pool with gate =
           Linear(feat, 1) over each molecule's motifs and its own pooled
           feature; motif_lin; pred head on cat(h, hp) [2 feat]
           (ginet_finetune_mp.py:79,104-107,141-165)
The state-dict keys are the reference's (x_embedding1/2, gnns.{i}.*,
batch_norms.{i}.*, feat_lin, out_lin.{0,2}, pred_head.{2i}, label_*,
motif_*), so a reference .pth loads directly.

The trunk takes the JAX package's two fused paths. With drop_ratio == 0
it is BN-chained: every conv layer is one kernel call that applies the
previous BatchNorm's affine + relu as its prologue and returns its masked
output moments, which MaskedBatchNorm turns into the next affine. With
drop_ratio > 0 (fine-tuning) it is unchained: each conv layer is one
fused_gine_layer / fused_gcn_layer call, then BatchNorm, relu and dropout.
The choice depends on the configuration alone, as in the JAX package, so
an eval-mode forward at drop_ratio 0.3 runs the unchained kernels too.
An ensemble's members (models of one configuration on one batch, the JAX
FineTuner's vmapped member axis) run their unchained tile trunks in
lockstep (`member_trunks`): per layer one member-axis kernel call over the
stacked inputs and weights, each member's BatchNorm, relu and dropout on
its own slice, and each member's node embeddings equal to its own trunk's
bit for bit.
With tile 0 the trunk takes the JAX package's ELL path (`resolve_fused` is
False there): no tile adjacency, every layer an ELL aggregation with its
dense parts in PyTorch (no hand-written kernel), then BatchNorm, relu and
dropout, whatever drop_ratio is; it takes molecules of any size.
"""

from __future__ import annotations

import torch
from torch import nn

from molclr_tpu_torch.data.featurize import NUM_ATOM_TYPES, NUM_CHIRALITY
from molclr_tpu_torch.models.layers import (
    GCNConv,
    GINEConv,
    MaskedBatchNorm,
    edge_counts,
    linear_in,
    reset_linear_,
    xavier_uniform_,
)
from molclr_tpu_torch.ops.scatter_free import embed_lookup
from molclr_tpu_torch.ops.segment import graph_pool
from molclr_tpu_torch.ops.tile_dense import (
    build_tile_adjacency,
    gcn_normalization,
    normalize_tile_adjacency,
)


def draw_keep(shape, rate: float, generator: torch.Generator | None,
              device) -> torch.Tensor:
    """A boolean keep mask of `shape`, each element kept with probability
    1 - rate, drawn from `generator` on `device`."""
    return torch.rand(shape, generator=generator, device=device) < 1.0 - rate


def dropout(h: torch.Tensor, rate: float, keep=None,
            generator: torch.Generator | None = None) -> torch.Tensor:
    """flax nn.Dropout in train mode: where(keep, h / (1 - rate), 0) in h's
    dtype, with 1 - rate cast to h's dtype first (as JAX casts the weakly
    typed scalar), keep drawn by draw_keep from `generator` (on h's
    device) unless the boolean mask `keep` [N, D] is given."""
    if keep is None:
        keep = draw_keep(h.shape, rate, generator, h.device)
    # the divisor as a tensor of h's dtype filled on h's device: a true
    # division by 1 - rate rounded to that dtype, and no host copy (which
    # a CUDA graph cannot capture)
    scale = torch.full((), 1.0 - rate, dtype=h.dtype, device=h.device)
    return torch.where(keep, h / scale, 0)


class Encoder(nn.Module):
    """The trunk and feat_lin that every network shares: `trunk(batch)`
    gives node embeddings, `encode(batch)` the pooled, projected molecule
    features [G, feat_dim].

    dtype is the activation dtype (f32 or bf16); parameters stay f32.
    Initial weights come from `generator` (a CPU torch.Generator); build
    the model on the CPU and move it with .to(device). normalize_gcn
    applies GCN's symmetric normalization (the GIN trunk ignores it, as
    the JAX model does). tile > 0 runs the tile-dense fused kernels on a
    batch packed with PadSpec(tile=tile); tile == 0 the ELL path.
    pool is 'mean', 'add' or 'max'. dp (a parallel.DPGroup, the JAX
    model's bn_axis_name) makes every BatchNorm sum its training moments
    across the data-parallel ranks."""

    def __init__(self, num_layers: int = 5, emb_dim: int = 300,
                 feat_dim: int = 512, gnn_type: str = "gin",
                 pool: str = "mean", drop_ratio: float = 0.0,
                 normalize_gcn: bool = False, dtype=torch.float32,
                 tile: int = 256, generator: torch.Generator | None = None,
                 dp=None):
        super().__init__()
        if gnn_type not in ("gin", "gcn"):
            raise ValueError(f"unknown gnn_type {gnn_type!r}")
        if tile < 0:
            raise ValueError(f"tile must be 0 (ELL) or positive, not {tile}")
        self.num_layers, self.emb_dim, self.feat_dim = \
            num_layers, emb_dim, feat_dim
        self.gnn_type, self.pool, self.dtype, self.tile = \
            gnn_type, pool, dtype, tile
        self.drop_ratio = float(drop_ratio)
        self.normalize_gcn = bool(normalize_gcn) and gnn_type == "gcn"
        g = generator
        self.x_embedding1 = nn.Embedding(NUM_ATOM_TYPES, emb_dim)
        self.x_embedding2 = nn.Embedding(NUM_CHIRALITY, emb_dim)
        xavier_uniform_(self.x_embedding1.weight, g)
        xavier_uniform_(self.x_embedding2.weight, g)
        if gnn_type == "gin":
            convs = (GINEConv(emb_dim, g) for _ in range(num_layers))
        else:
            convs = (GCNConv(emb_dim, g, self.normalize_gcn)
                     for _ in range(num_layers))
        self.gnns = nn.ModuleList(convs)
        self.batch_norms = nn.ModuleList(
            MaskedBatchNorm(emb_dim, dp=dp) for _ in range(num_layers))
        self.feat_lin = reset_linear_(nn.Linear(emb_dim, feat_dim), g)

    def embed_nodes(self, batch) -> torch.Tensor:
        """The trunk's input [N, emb_dim]: atom plus chirality embeddings
        in the activation dtype, zero on padding rows."""
        h = (embed_lookup(self.x_embedding1.weight, batch.atom_type)
             + embed_lookup(self.x_embedding2.weight, batch.chirality))
        return torch.where(batch.node_mask[:, None], h.to(self.dtype), 0)

    def trunk(self, batch, dropout_masks=None,
              generator: torch.Generator | None = None) -> torch.Tensor:
        """Node embeddings [N, emb_dim]. In training mode with drop_ratio >
        0, dropout takes its keep masks from `dropout_masks` (one bool
        [N, emb_dim] tensor per layer) or draws them from `generator` (a
        torch.Generator on the model's device); one of the two is
        required."""
        dt = self.dtype
        mask = batch.node_mask[:, None]
        h = self.embed_nodes(batch)
        adj = cnt = None
        chained = self.drop_ratio == 0.0 and self.tile > 0
        if self.tile:
            adj = build_tile_adjacency(batch.nbr, batch.nbr_mask, self.tile,
                                       dtype=dt)
            w = batch.nbr_mask.to(dt)
            if chained and self.normalize_gcn:
                # bake the symmetric normalization into the shared
                # adjacency and edge counts once (the unchained GCNConv
                # does it per layer)
                dis, w = gcn_normalization(batch.nbr, batch.nbr_mask, dt)
                adj = normalize_tile_adjacency(adj, dis)
            cnt = edge_counts(batch, w)
        last = self.num_layers - 1
        if chained:
            count = batch.node_mask.float().sum()
            d = self.emb_dim
            a = torch.ones(d, device=h.device)
            b = torch.zeros(d, device=h.device)
            relu_in = False
            for layer, (conv, bn) in enumerate(zip(self.gnns,
                                                   self.batch_norms)):
                out, sums = conv(h, adj, cnt, (a, b, relu_in))
                a, b = bn((sums[0], sums[1], count))
                if layer == last:
                    h = torch.where(mask, out * a.to(dt) + b.to(dt), 0)
                else:
                    h, relu_in = out, True
            return h
        return unchained_layers([self], [h], adj, cnt, batch,
                                [dropout_masks], generator)[0]

    def keep_masks(self, n: int, generator: torch.Generator
                   ) -> list[torch.Tensor]:
        """The keep masks [n, emb_dim] that a train-mode trunk on a batch
        of n nodes draws from `generator`, one per layer, in its order (so
        that trunk(batch, dropout_masks=these) equals trunk(batch,
        generator=generator) from the same generator state)."""
        dev = next(self.parameters()).device
        return [draw_keep((n, self.emb_dim), self.drop_ratio, generator,
                          dev) for _ in range(self.num_layers)]

    def encode(self, batch, dropout_masks=None,
               generator: torch.Generator | None = None,
               h: torch.Tensor | None = None) -> torch.Tensor:
        """Pooled molecule features after feat_lin [G, feat_dim]; h: the
        node embeddings when member_trunks computed them, else the trunk
        runs here."""
        if h is None:
            h = self.trunk(batch, dropout_masks, generator)
        hg = graph_pool(h, batch.node_graph, batch.node_mask,
                        batch.num_graphs, batch.graph_n_nodes, self.pool)
        return linear_in(self.feat_lin, hg, self.dtype)


def unchained_layers(models, hs, adj, cnt, batch, dropout_masks,
                     generator: torch.Generator | None = None) -> list:
    """The unchained trunk's layers (conv, BatchNorm, relu but after the
    last, dropout in training mode) of M members of one configuration on
    one batch, from their inputs hs. One member: each conv its own kernel
    call (or, with adj None, its ELL aggregation). M > 1 on a tile
    adjacency: per layer one member-axis call over the stacked inputs and
    weights (the convs' members_forward, the JAX FineTuner's vmapped
    layer), then each member's BatchNorm, relu and dropout on its slice;
    dropout then takes each member's keep masks from dropout_masks[m] (one
    bool [N, emb_dim] per layer). Returns each member's node embeddings,
    those of its own trunk bit for bit."""
    first = models[0]
    drop = first.training and first.drop_ratio > 0
    lockstep = len(models) > 1 and adj is not None
    for masks in dropout_masks:
        if drop and masks is None and (generator is None or lockstep):
            raise ValueError("training with dropout needs dropout_masks"
                             + ("" if lockstep else " or a generator"))
    last = first.num_layers - 1
    for layer in range(first.num_layers):
        convs = [model.gnns[layer] for model in models]
        if lockstep:
            outs = type(convs[0]).members_forward(convs, hs, adj, cnt, batch)
        else:
            outs = [conv(h, adj, cnt, batch=batch)
                    for conv, h in zip(convs, hs)]
        hs = []
        for model, out, masks in zip(models, outs, dropout_masks):
            h = model.batch_norms[layer](out, batch.node_mask)
            if layer != last:
                h = torch.relu(h)
            if drop:
                h = dropout(h, first.drop_ratio,
                            None if masks is None else masks[layer],
                            generator)
            hs.append(h)
    return hs


def member_trunks(models, batch, dropout_masks=None) -> list:
    """The node embeddings of an ensemble's members (models of one
    configuration, in one mode) on one batch, from one lockstep pass of
    their unchained tile trunks (unchained_layers; dropout_masks[m] member
    m's keep masks in training mode); None for each member where that is
    not their path (one member, the BN-chained or the ELL trunk, a network
    without an Encoder trunk: each runs its own in its forward)."""
    first = models[0]
    if len(models) < 2 or not isinstance(first, Encoder) \
            or not (first.tile > 0 and first.drop_ratio > 0):
        return [None] * len(models)
    adj = build_tile_adjacency(batch.nbr, batch.nbr_mask, first.tile,
                               dtype=first.dtype)
    cnt = edge_counts(batch, batch.nbr_mask.to(first.dtype))
    return unchained_layers(
        models, [model.embed_nodes(batch) for model in models], adj, cnt,
        batch, dropout_masks or [None] * len(models))


class MolCLRNet(Encoder):
    """Pretraining network: trunk + pool + feat_lin + projection head."""

    def __init__(self, *args, generator: torch.Generator | None = None,
                 **kwargs):
        super().__init__(*args, generator=generator, **kwargs)
        g, f = generator, self.feat_dim
        self.out_lin = nn.Sequential(
            reset_linear_(nn.Linear(f, f), g), nn.ReLU(),
            reset_linear_(nn.Linear(f, f // 2), g))

    def forward(self, batch, dropout_masks=None, generator=None):
        """batch: a GraphBatch of tensors on the model's device. Returns
        (h [G, feat_dim], z [G, feat_dim // 2])."""
        hg = self.encode(batch, dropout_masks, generator)
        cd = self.dtype
        z = torch.relu(linear_in(self.out_lin[0], hg, cd))
        return hg, linear_in(self.out_lin[2], z, cd)


_ACTIVATIONS = {"softplus": nn.Softplus, "relu": nn.ReLU}


def _pred_head(feat_in: int, feat_dim: int, out_dim: int, pred_n_layer: int,
               pred_act: str, generator) -> nn.Sequential:
    """Linear(feat_in, feat/2), act, [Linear(feat/2, feat/2), act] x
    (pred_n_layer - 1), Linear(feat/2, out_dim): the JAX package's pred_0,
    pred_i and pred_out at Sequential indices 0, 2, ..."""
    act = _ACTIVATIONS[pred_act]
    half = feat_dim // 2
    mods = [reset_linear_(nn.Linear(feat_in, half), generator), act()]
    for _ in range(1, max(1, pred_n_layer)):
        mods += [reset_linear_(nn.Linear(half, half), generator), act()]
    mods.append(reset_linear_(nn.Linear(half, out_dim), generator))
    return nn.Sequential(*mods)


def _apply_head(head: nn.Sequential, x: torch.Tensor, dtype) -> torch.Tensor:
    for mod in head:
        x = linear_in(mod, x, dtype) if isinstance(mod, nn.Linear) else mod(x)
    return x


class FineTuneNet(Encoder):
    """Fine-tune network: trunk + pool + feat_lin + prediction head;
    forward returns (h [G, feat_dim], pred [G, out_dim]) with out_dim 2
    for task 'classification' and 1 for 'regression'."""

    def __init__(self, task: str = "classification", *args,
                 pred_n_layer: int = 2, pred_act: str = "softplus",
                 generator: torch.Generator | None = None, **kwargs):
        super().__init__(*args, generator=generator, **kwargs)
        self.task = task
        out_dim = 2 if task == "classification" else 1
        self.pred_head = _pred_head(self._head_in(), self.feat_dim, out_dim,
                                    pred_n_layer, pred_act, generator)

    def _head_in(self) -> int:
        return self.feat_dim

    def forward(self, batch, dropout_masks=None, generator=None, h=None):
        """(h [G, feat_dim], pred [G, out_dim]); h: precomputed node
        embeddings (member_trunks)."""
        hg = self.encode(batch, dropout_masks, generator, h)
        return hg, _apply_head(self.pred_head, hg, self.dtype)


class LinkFineTuneNet(Encoder):
    """The label-embedding ("link") fine-tune network: each molecule's
    pooled feature is concatenated with label_lin(label_embedding[y]) for
    y in {0, 1}, and each pair runs through one shared pred head [2 feat]
    -> 1; forward returns (h [G, feat_dim], pred [G, 2]). The label table,
    label_lin and the head compute in f32 (the JAX model's dense layers
    without a dtype promote a bf16 h to f32)."""

    def __init__(self, *args, pred_n_layer: int = 2,
                 pred_act: str = "softplus",
                 generator: torch.Generator | None = None, **kwargs):
        super().__init__(*args, generator=generator, **kwargs)
        f = self.feat_dim
        self.label_embedding = nn.Parameter(torch.empty(2, f))
        with torch.no_grad():
            self.label_embedding.normal_(generator=generator)
        self.label_lin = nn.Linear(f, f)
        xavier_uniform_(self.label_lin.weight, generator)
        with torch.no_grad():
            self.label_lin.bias.zero_()
        self.pred_head = _pred_head(2 * f, f, 1, pred_n_layer, pred_act,
                                    generator)

    def forward(self, batch, dropout_masks=None, generator=None):
        hg = self.encode(batch, dropout_masks, generator)
        lab = self.label_lin(self.label_embedding)             # [2, F]
        g, f = hg.shape[0], self.feat_dim
        scores = [_apply_head(self.pred_head, torch.cat(
            [hg.float(), lab[y].expand(g, f)], dim=-1), torch.float32)
            for y in range(2)]
        return hg, torch.cat(scores, dim=-1)


class _AttentionPool(nn.Module):
    """The gate of PyG's GlobalAttention (state-dict key gate_nn.0)."""

    def __init__(self, feat_dim: int, generator):
        super().__init__()
        self.gate_nn = nn.Sequential(
            reset_linear_(nn.Linear(feat_dim, 1), generator))


class MotifFineTuneNet(FineTuneNet):
    """Fine-tune network with the motif message-passing head. forward takes
    motif_ids [G, C] (indices into the motif vocabulary) and motif_mask
    [G, C] besides the batch; each molecule's attention segment is its C
    motif embeddings plus its own pooled feature, pooled with softmax(gate)
    weights (masked slots' gate logits set to -1e30). Returns (cat(h, hp)
    [G, 2 feat_dim], pred)."""

    def __init__(self, num_motifs: int = 1, task: str = "classification",
                 *args, generator: torch.Generator | None = None, **kwargs):
        super().__init__(task, *args, generator=generator, **kwargs)
        f = self.feat_dim
        self.motif_embedding = nn.Embedding(num_motifs, f)
        with torch.no_grad():
            self.motif_embedding.weight.normal_(generator=generator)
        self.motif_pool = _AttentionPool(f, generator)
        self.motif_lin = nn.Linear(f, f)
        xavier_uniform_(self.motif_lin.weight, generator)
        with torch.no_grad():
            self.motif_lin.bias.zero_()

    def _head_in(self) -> int:
        return 2 * self.feat_dim

    def forward(self, batch, motif_ids, motif_mask, dropout_masks=None,
                generator=None, h=None):
        hg = self.encode(batch, dropout_masks, generator, h)
        me = embed_lookup(self.motif_embedding.weight, motif_ids)  # [G, C, F]
        # (a bf16 hg meets the f32 motif table: the slots are f32, as in
        # the JAX package)
        slots = torch.cat([me, hg[:, None, :].to(me.dtype)], dim=1)
        slot_mask = torch.cat([motif_mask, batch.graph_mask[:, None]], dim=1)
        gate = self.motif_pool.gate_nn[0](slots)[..., 0]          # [G, C+1]
        gate = torch.where(slot_mask, gate, -1e30)
        alpha = torch.softmax(gate, dim=-1)
        hp = self.motif_lin((alpha[..., None] * slots).sum(dim=1))
        cat = torch.cat([hg.to(hp.dtype), hp], dim=-1)
        return cat, _apply_head(self.pred_head, cat, self.dtype)

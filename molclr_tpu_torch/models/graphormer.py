"""Graphormer (Ying et al., "Do Transformers Really Perform Bad for Graph
Representation?", NeurIPS 2021, arXiv:2106.05234; github.com/microsoft/
Graphormer) as a fine-tuning network on the port's tile-packed batches.

  input    x_i = E_atom[type_i] + E_chir[chir_i] + Z_in[deg_i + 1] +
           Z_out[deg_i + 1] (the undirected degree, hydrogens counted;
           Graphormer's collator shifts it by one), the graph token's row
           a learned vector; dropout
  bias     B[h, i, j] for atoms i, j of one molecule at distance phi:
           b[phi + 1, h] + (1 / N) sum_{n <= N} (e_n W_n)[h], N = min(phi,
           max_hops) (at least 1), e_n the mean of the bond-type and
           bond-direction embeddings of the n-th bond of the path
           (data/graphormer.py), W_n the n-th of the hop matrices; t[h]
           for the graph token with an atom of its molecule, either way,
           and with itself; every other pair masked out. One bias a
           forward, shared by all layers
  layer    pre-LN (the paper's eqs. 8-9): x += drop(MHA(LN(x))) with
           scores (q / sqrt(d_h)) k^T + B before the softmax, dropout on
           the probabilities; x += drop(fc2(drop(gelu(fc1(LN(x))))))
  readout  final LN; each molecule's graph-token row; Linear, GELU, LN,
           Linear to the logits (2) or the regression output (1)

The attention runs over the packed batch's tiles of S rows ([T, heads, S,
S] scores), where each molecule with its graph token lies inside one
tile; a padding row attends to itself alone, so every row's softmax is
finite and no real row reads a padding row. f32 only.

Every step gives the same bits on every run, graphed or eager: the
tables' gradients are one-hot products (`embed_lookup` for the atom,
chirality and degree tables and the token rows' readout; `table_grad`
for the spatial and hop tables, a few tiles at a time), where
F.embedding's and indexing's backwards on the card add with atomics; the
LayerNorms normalize without their affine and apply it apart, since
their shift's gradient on the card adds with atomics too. The bias
(`graphormer.bias`) and the attention (`graphormer.attn`) are autograd
Functions whose backwards run under their ranges; `graphormer.ffn` covers
the FFN's forward only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from molclr_tpu_torch.data.featurize import NUM_ATOM_TYPES, NUM_BOND_DIRS, \
    NUM_BOND_TYPES, NUM_CHIRALITY
from molclr_tpu_torch.data.graphormer import GRAPH_TOKEN_TYPE, UNREACHABLE
from molclr_tpu_torch.models.nets import draw_keep, dropout
from molclr_tpu_torch.ops.scatter_free import embed_lookup
from molclr_tpu_torch.train.spans import span

# Graphormer's table sizes (transformers' GraphormerConfig num_in_degree,
# num_out_degree, num_spatial, num_edge_dis)
NUM_DEGREES = 512
NUM_SPATIAL = 512
NUM_EDGE_DIS = 128
INIT_STD = 0.02                 # Graphormer's init: N(0, 0.02)
ONEHOT_ELEMENTS = 1 << 27       # one-hot entries a table_grad product takes


def table_grad(ids: torch.Tensor, g: torch.Tensor, rows: int) -> torch.Tensor:
    """[rows, H]: g [T, S, S, H] summed by the table rows ids [T, S, S] (in
    0..rows-1), as one-hot products over a few tiles at a time (at most
    ONEHOT_ELEMENTS one-hot entries) summed in tile order."""
    t, h = ids.shape[0], g.shape[-1]
    ids, g = ids.reshape(t, -1), g.reshape(t, -1, h)
    classes = torch.arange(rows, device=ids.device)[None, :, None]
    chunk = max(1, ONEHOT_ELEMENTS // (rows * ids.shape[1]))
    out = None
    for lo in range(0, t, chunk):
        onehot = (ids[lo: lo + chunk, None, :] == classes).to(g.dtype)
        part = torch.bmm(onehot, g[lo: lo + chunk]).sum(0)
        out = part if out is None else out + part
    return out


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """ln(x), its affine apart from the normalization (module
    docstring)."""
    return F.layer_norm(x, ln.normalized_shape, eps=ln.eps) * ln.weight \
        + ln.bias


class _AttentionBias(torch.autograd.Function):
    """B [T, heads, S, S] from the spatial table sw, the graph token's
    distance tw, the hop table (the bond ids' rows of hop n at n x rows
    per hop) and the batch's pair data: spatial rows and path bond ids,
    the pairs allowed, those of two atoms and those with a graph token;
    -inf where a pair is masked out."""

    @staticmethod
    def forward(ctx, sw, tw, table, spatial, path, allowed, atoms, token):
        with span("graphormer.bias"):
            hops = path.shape[-1]
            per_hop = table.shape[0] // hops
            ids = path.long() + per_hop * torch.arange(hops,
                                                       device=path.device)
            n_hops = (spatial - 1).clamp(min=1, max=hops)[..., None].to(
                sw.dtype)
            b = torch.where(atoms[..., None], F.embedding(spatial, sw), 0)
            edge = F.embedding(ids[..., 0], table)
            for n in range(1, hops):
                edge = edge + F.embedding(ids[..., n], table)
            b = b + edge / n_hops
            b = b + torch.where(token[..., None], tw, 0)
            b = torch.where(allowed[..., None], b, float("-inf"))
            bias = b.permute(0, 3, 1, 2).contiguous()
        ctx.save_for_backward(spatial, ids, n_hops, atoms, token)
        ctx.rows = (sw.shape[0], table.shape[0])
        return bias

    @staticmethod
    def backward(ctx, g):
        spatial, ids, n_hops, atoms, token = ctx.saved_tensors
        with span("graphormer.bias"):
            gp = g.permute(0, 2, 3, 1)                 # [T, S, S, H]
            # an atom pair's row is its distance + 1 < S, or UNREACHABLE + 1
            s = gp.shape[1]
            ga = torch.where(atoms[..., None], gp, 0)
            far = spatial == UNREACHABLE + 1
            d_sw = torch.zeros(ctx.rows[0], gp.shape[-1], dtype=g.dtype,
                               device=g.device)
            d_sw[:s] = table_grad(torch.where(far, 0, spatial),
                                  torch.where(far[..., None], 0, ga), s)
            d_sw[UNREACHABLE + 1] = torch.where(far[..., None], ga, 0).sum(
                (0, 1, 2))
            ge = gp / n_hops
            per_hop = ctx.rows[1] // ids.shape[-1]
            d_table = torch.cat([
                table_grad(ids[..., n] - n * per_hop, ge, per_hop)
                for n in range(ids.shape[-1])])
            d_tw = torch.where(token[..., None], gp, 0).sum((0, 1, 2))[None]
        return d_sw, d_tw, d_table, None, None, None, None, None


class _TileAttention(torch.autograd.Function):
    """softmax(q k^T + bias) with dropout keep masks on the probabilities,
    times v, over [T, heads, S, ...]; saves the probabilities and
    computes its backward by hand, both under `graphormer.attn`."""

    @staticmethod
    def forward(ctx, q, k, v, bias, keep, rate: float):
        with span("graphormer.attn"):
            p = torch.softmax(q @ k.transpose(-1, -2) + bias, dim=-1)
            scale = None
            if keep is not None:
                scale = torch.full((), 1.0 - rate, dtype=p.dtype,
                                   device=p.device)
                pd = torch.where(keep, p / scale, 0)
            else:
                pd = p
            out = pd @ v
        ctx.save_for_backward(q, k, v, p, keep, scale)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, p, keep, scale = ctx.saved_tensors
        with span("graphormer.attn"):
            pd = p if keep is None else torch.where(keep, p / scale, 0)
            dv = pd.transpose(-1, -2) @ g
            dp = g @ v.transpose(-1, -2)
            if keep is not None:
                dp = torch.where(keep, dp / scale, 0)
            ds = p * (dp - (dp * p).sum(-1, keepdim=True))
            dq = ds @ k
            dk = ds.transpose(-1, -2) @ q
        return dq, dk, dv, ds, None, None


def _init_(net: nn.Module, generator) -> None:
    """Graphormer's init: linear weights, embeddings and the free
    parameters N(0, 0.02), biases 0, LayerNorms 1 and 0."""
    with torch.no_grad():
        for p in net.parameters():
            p.normal_(0.0, INIT_STD, generator=generator)
        for m in net.modules():
            if isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
            if isinstance(m, (nn.Linear, nn.LayerNorm)):
                m.bias.zero_()


class GraphormerLayer(nn.Module):
    """One pre-LN encoder layer."""

    def __init__(self, emb_dim: int, ffn_dim: int, num_heads: int):
        super().__init__()
        if emb_dim % num_heads:
            raise ValueError(f"emb_dim {emb_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.num_heads = num_heads
        self.attn_norm = nn.LayerNorm(emb_dim)
        self.q = nn.Linear(emb_dim, emb_dim)
        self.k = nn.Linear(emb_dim, emb_dim)
        self.v = nn.Linear(emb_dim, emb_dim)
        self.out = nn.Linear(emb_dim, emb_dim)
        self.ffn_norm = nn.LayerNorm(emb_dim)
        self.fc1 = nn.Linear(emb_dim, ffn_dim)
        self.fc2 = nn.Linear(ffn_dim, emb_dim)

    def forward(self, x, bias, keep, rate: float, tile: int):
        """x [N, D]; bias [T, heads, S, S]; keep: this layer's keep masks
        (None in evaluation)."""
        n, d = x.shape
        h = self.num_heads
        dh = d // h
        y = layer_norm(self.attn_norm, x)

        def split(t):
            return t.view(n // tile, tile, h, dh).transpose(1, 2)

        o = _TileAttention.apply(split(self.q(y) * dh ** -0.5),
                                 split(self.k(y)), split(self.v(y)), bias,
                                 None if keep is None else keep["attn"],
                                 rate)
        a = self.out(o.transpose(1, 2).reshape(n, d))
        if keep is not None:
            a = dropout(a, rate, keep["attn_out"])
        x = x + a
        with span("graphormer.ffn"):
            y = F.gelu(self.fc1(layer_norm(self.ffn_norm, x)))
            if keep is not None:
                y = dropout(y, rate, keep["act"])
            y = self.fc2(y)
            if keep is not None:
                y = dropout(y, rate, keep["ffn_out"])
        return x + y


class GraphormerNet(nn.Module):
    """Graphormer on tile-packed batches whose molecules each begin with
    a graph-token row (data/graphormer.py); forward(batch, spatial, path)
    returns (the graph tokens' final rows [G, D], pred [G, out_dim]) with
    out_dim 2 for task 'classification' and 1 for 'regression'. Build on
    the CPU from `generator` and move with .to(device)."""

    def __init__(self, task: str = "classification", num_layers: int = 12,
                 emb_dim: int = 768, ffn_dim: int = 768, num_heads: int = 32,
                 max_hops: int = 5, drop_ratio: float = 0.1,
                 tile: int = 256, generator: torch.Generator | None = None):
        super().__init__()
        if not 0 < tile <= UNREACHABLE:
            raise ValueError(f"Graphormer attends within tiles: 0 < tile <= "
                             f"{UNREACHABLE} (the spatial table's rows)")
        if not 0 < max_hops <= NUM_EDGE_DIS:
            raise ValueError(f"max_hops must lie in 1..{NUM_EDGE_DIS}")
        self.task, self.num_layers, self.emb_dim = task, num_layers, emb_dim
        self.ffn_dim, self.num_heads, self.max_hops = ffn_dim, num_heads, \
            max_hops
        self.drop_ratio, self.tile = float(drop_ratio), tile
        d, h = emb_dim, num_heads
        self.atom_embedding = nn.Embedding(NUM_ATOM_TYPES, d)
        self.chirality_embedding = nn.Embedding(NUM_CHIRALITY, d)
        self.in_degree_embedding = nn.Embedding(NUM_DEGREES, d)
        self.out_degree_embedding = nn.Embedding(NUM_DEGREES, d)
        self.graph_token = nn.Parameter(torch.empty(1, d))
        self.spatial_embedding = nn.Embedding(NUM_SPATIAL, h)
        self.graph_token_distance = nn.Parameter(torch.empty(1, h))
        self.edge_type_embedding = nn.Embedding(NUM_BOND_TYPES, h)
        self.edge_dir_embedding = nn.Embedding(NUM_BOND_DIRS, h)
        self.edge_hop_weight = nn.Parameter(torch.empty(NUM_EDGE_DIS, h, h))
        self.layers = nn.ModuleList(GraphormerLayer(d, ffn_dim, h)
                                    for _ in range(num_layers))
        self.final_norm = nn.LayerNorm(d)
        out_dim = 2 if task == "classification" else 1
        self.pred_head = nn.Sequential(nn.Linear(d, d), nn.GELU(),
                                       nn.LayerNorm(d), nn.Linear(d, out_dim))
        _init_(self, generator)

    def keep_masks(self, n: int, generator: torch.Generator) -> dict:
        """The keep masks of one train-mode forward on a batch of n rows,
        drawn from `generator` in this order: the input [n, D], then per
        layer the attention probabilities [T, heads, S, S], the attention
        output [n, D], the activation [n, ffn_dim] and the FFN output
        [n, D]."""
        dev = self.graph_token.device
        s, d, r = self.tile, self.emb_dim, self.drop_ratio

        def draw(*shape):
            return draw_keep(shape, r, generator, dev)

        masks = {"input": draw(n, d), "layers": []}
        for _ in range(self.num_layers):
            masks["layers"].append({
                "attn": draw(n // s, self.num_heads, s, s),
                "attn_out": draw(n, d), "act": draw(n, self.ffn_dim),
                "ffn_out": draw(n, d)})
        return masks

    def embed_nodes(self, batch, token: torch.Tensor) -> torch.Tensor:
        """The input rows [N, D]: the atoms' embeddings, the graph token's
        vector on token rows, zero on padding rows."""
        deg = (batch.nbr_mask.sum(1) - 1).clamp(min=0) + 1
        x = (embed_lookup(self.atom_embedding.weight,
                          batch.atom_type.clamp(max=NUM_ATOM_TYPES - 1))
             + embed_lookup(self.chirality_embedding.weight, batch.chirality)
             + embed_lookup(self.in_degree_embedding.weight, deg)
             + embed_lookup(self.out_degree_embedding.weight, deg))
        x = torch.where(token[:, None], self.graph_token, x)
        return torch.where(batch.node_mask[:, None], x, 0)

    def attention_bias(self, batch, spatial, path, token) -> torch.Tensor:
        """B [T, heads, S, S] (module docstring), -inf where a pair is
        masked out."""
        s, h, hops = self.tile, self.num_heads, self.max_hops
        t = batch.num_nodes // s
        graph = batch.node_graph.view(t, s)
        real = batch.node_mask.view(t, s)
        tok = token.view(t, s)
        same = ((graph[:, :, None] == graph[:, None, :])
                & real[:, :, None] & real[:, None, :])
        allowed = same | torch.eye(s, dtype=torch.bool, device=same.device)
        sp = spatial.long()
        # the hop table: row 0 (no bond) zero, bond id c at row c, hop n's
        # rows after hop n - 1's
        bonds = (self.edge_type_embedding.weight[:, None, :]
                 + self.edge_dir_embedding.weight[None, :, :]) / 2
        bonds = torch.cat([bonds.new_zeros(1, h), bonds.reshape(-1, h)])
        table = (bonds[None] @ self.edge_hop_weight[:hops]).reshape(-1, h)
        return _AttentionBias.apply(
            self.spatial_embedding.weight, self.graph_token_distance, table,
            sp, path, allowed, sp > 0,
            (tok[:, :, None] | tok[:, None, :]) & same)

    def forward(self, batch, spatial, path, dropout_masks=None,
                generator: torch.Generator | None = None, h=None):
        """(the graph tokens' rows [G, D], pred [G, out_dim]). In training
        mode dropout takes `dropout_masks` (keep_masks' dict) or draws them
        from `generator`; h is the trunks' lockstep slot of the FineTuner
        and unused."""
        n = batch.num_nodes
        keep = None
        if self.training and self.drop_ratio > 0:
            keep = dropout_masks
            if keep is None:
                if generator is None:
                    raise ValueError("training with dropout needs "
                                     "dropout_masks or a generator")
                keep = self.keep_masks(n, generator)
        token = batch.atom_type == GRAPH_TOKEN_TYPE
        x = self.embed_nodes(batch, token)
        if keep is not None:
            x = dropout(x, self.drop_ratio, keep["input"])
        bias = self.attention_bias(batch, spatial, path, token)
        for i, layer in enumerate(self.layers):
            x = layer(x, bias, None if keep is None else keep["layers"][i],
                      self.drop_ratio, self.tile)
        x = layer_norm(self.final_norm, x)
        # each molecule's graph-token row (padding slots read row 0)
        rows = torch.arange(n, device=x.device)
        at = torch.zeros(batch.num_graphs, dtype=torch.long,
                         device=x.device).scatter_reduce(
            0, batch.node_graph, torch.where(token & batch.node_mask, rows,
                                             0), "amax")
        hg = embed_lookup(x, at)
        lin0, act, norm, lin1 = self.pred_head
        return hg, lin1(layer_norm(norm, act(lin0(hg))))

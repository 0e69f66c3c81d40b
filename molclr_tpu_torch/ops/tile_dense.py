"""Tile-dense neighborhood aggregation: block-diagonal adjacency matmuls.

Port of molclr_tpu/ops/tile_dense.py (`build_tile_adjacency`,
`tile_matmul`, `gcn_edge_term`) and of the symmetric GCN normalization that
molclr_tpu/models (nets.py GNNTrunk, layers.py GCNConv) apply to the
adjacency and the edge counts (`gcn_normalization`,
`normalize_tile_adjacency`). When every molecule sits inside one
`tile`-node block (PadSpec.tile), the batch adjacency is block-diagonal and aggregation is
the batched matmul  out.view(T, tile, D) = A @ h.view(T, tile, D)  with
A: [T, tile, tile], symmetric per block (undirected bonds + slot-0
self-loop).
"""

from __future__ import annotations

import torch

from molclr_tpu_torch.ops.scatter_free import _counts


def build_tile_adjacency(nbr: torch.Tensor, mask: torch.Tensor, tile: int,
                         dtype=torch.bfloat16, w=None) -> torch.Tensor:
    """Block-diagonal adjacency [T, tile, tile] from the masked ELL view.

    A[t, i, j] = sum_k w[t*tile+i, k] * [nbr[t*tile+i, k] == t*tile+j]

    nbr  [N, K] global neighbor ids (slot 0 = self-loop)
    mask [N, K] bool
    w    [N, K] optional weights (symmetric in node/neighbor); defaults to
         mask.
    Padded rows are zero (their mask is False); out-of-tile ids of padded
    slots one-hot to zero."""
    n = nbr.shape[0]
    if n % tile:
        raise ValueError(f"{n} nodes not a multiple of tile {tile}")
    base = (torch.arange(n, device=nbr.device) // tile) * tile
    local = nbr - base[:, None]
    wts = mask.to(dtype) if w is None else w.to(dtype)
    return _counts(local, wts, tile).reshape(n // tile, tile, tile)


def tile_matmul(adj: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """out = blockdiag(adj) @ h: [T,S,S] x [N,D] -> [N,D] with N = T*S,
    accumulated in f32 and cast back to h's dtype."""
    t, s, _ = adj.shape
    out = torch.bmm(adj.float(), h.float().reshape(t, s, h.shape[-1]))
    return out.reshape(h.shape).to(h.dtype)


def gcn_normalization(nbr: torch.Tensor, nbr_mask: torch.Tensor, dtype):
    """The symmetric GCN normalization of the masked ELL view, in `dtype`
    (normalize_gcn, which fixes the reference's quirk Q2): dis [N] =
    rsqrt(max(deg, 1)) with deg the node's live slots, self-loop included,
    and the slot weights w [N, K] = mask * (dis[nbr] * dis[n]), each
    operation rounded in `dtype` as the JAX package computes it. w weights
    the edge counts (gcn_edge_term's cnt); dis scales the adjacency
    (normalize_tile_adjacency)."""
    deg = nbr_mask.sum(dim=1).to(dtype)
    dis = torch.rsqrt(torch.clamp(deg, min=1.0))
    norm = dis[nbr] * dis[:, None]
    return dis, nbr_mask.to(dtype) * norm


def normalize_tile_adjacency(adj: torch.Tensor,
                             dis: torch.Tensor) -> torch.Tensor:
    """adj[t, i, j] * dis_i * dis_j per tile, the weights cast to adj's
    dtype and the product taken in it (still symmetric, so the adjoint of
    A @ . stays A @ .)."""
    dis_b = dis.reshape(-1, adj.shape[-1])
    return adj * (dis_b[:, :, None] * dis_b[:, None, :]).to(adj.dtype)


def gcn_edge_term(t_type: torch.Tensor, t_dir: torch.Tensor,
                  cnt: torch.Tensor, dtype) -> torch.Tensor:
    """The [N, 1] scalar edge-embedding sum of GCN aggregation: over each
    node's incident edges, Emb1(bond_type) + Emb2(bond_dir), weighted by
    the symmetric normalization when cnt carries it. cnt is a packed count
    matrix [N, CNT_PAD] (bond-type counts ++ bond-dir counts ++ zeros,
    ops/fused_layer.pack_cnt), the `_counts` the JAX function builds from
    the same weights: the mask, or mask * norm (gcn_normalization's w).
    Each product is accumulated in f32 and cast to `dtype`, then the two
    are added in `dtype`."""
    nt, nd = t_type.shape[0], t_dir.shape[0]
    cf = cnt.float()
    return ((cf[:, :nt] @ t_type.to(dtype).float()).to(dtype)
            + (cf[:, nt:nt + nd] @ t_dir.to(dtype).float()).to(dtype))

"""Tile-dense neighborhood aggregation: block-diagonal adjacency matmuls.

Port of molclr_tpu/ops/tile_dense.py (`build_tile_adjacency`,
`tile_matmul`, `gcn_edge_term`). When every molecule sits inside one
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


def gcn_edge_term(t_type: torch.Tensor, t_dir: torch.Tensor,
                  cnt: torch.Tensor, dtype) -> torch.Tensor:
    """The [N, 1] scalar edge-embedding sum of GCN aggregation: over each
    node's incident edges, Emb1(bond_type) + Emb2(bond_dir). cnt is the
    trunk's packed count matrix [N, CNT_PAD] (bond-type counts ++ bond-dir
    counts ++ zeros, ops/fused_layer.pack_cnt), the `_counts` the JAX
    function builds from the same mask. Each product is accumulated in f32
    and cast to `dtype`, then the two are added in `dtype`. The symmetric
    normalization (normalize_gcn) is not ported."""
    nt, nd = t_type.shape[0], t_dir.shape[0]
    cf = cnt.float()
    return ((cf[:, :nt] @ t_type.to(dtype).float()).to(dtype)
            + (cf[:, nt:nt + nd] @ t_dir.to(dtype).float()).to(dtype))

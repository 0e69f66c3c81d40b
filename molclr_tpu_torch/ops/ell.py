"""Neighborhood aggregation over the ELL view and over COO edges.

Port of molclr_tpu/ops/ell.py (`ell_aggregate`, `coo_aggregate`): plain
functions that state the message semantics of GINEConv / GCNConv, kept as
references for tests (the trunk runs ops/scatter_free.py's aggregations):

    message(e) = x[src(e)] + edge_emb(e)
    aggregate  = sum over in-edges + the self-loop

`ell_aggregate` forms the [N, K, D] messages, and its backward is
PyTorch's indexing backward.
"""

from __future__ import annotations

import torch

from molclr_tpu_torch.ops.segment import segment_sum


def ell_aggregate(h: torch.Tensor, nbr: torch.Tensor,
                  nbr_mask: torch.Tensor,
                  edge_emb: torch.Tensor | None = None) -> torch.Tensor:
    """sum_k mask[n,k] * (h[nbr[n,k]] + edge_emb[n,k]).

    h [N, D]; nbr [N, K] (slot 0 the self-loop); nbr_mask [N, K] bool;
    edge_emb [N, K, D] or None. Returns [N, D]."""
    msg = h[nbr]                                   # [N, K, D]
    if edge_emb is not None:
        msg = msg + edge_emb
    msg = torch.where(nbr_mask[..., None], msg, 0)
    return msg.sum(dim=1)


def coo_aggregate(h: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                  edge_mask: torch.Tensor, num_nodes: int,
                  edge_emb: torch.Tensor | None = None,
                  self_loop_emb: torch.Tensor | None = None,
                  node_mask: torch.Tensor | None = None) -> torch.Tensor:
    """The same sum over COO edges plus an explicit self-loop term.

    edge_emb       [E, D] per directed edge, or None
    self_loop_emb  [D] or [N, D]: the self-loop's edge embedding, added for
                   every real node."""
    msg = h[src]
    if edge_emb is not None:
        msg = msg + edge_emb
    out = segment_sum(msg, dst, num_nodes, edge_mask)
    self_term = h
    if self_loop_emb is not None:
        self_term = self_term + self_loop_emb
    if node_mask is not None:
        self_term = torch.where(node_mask[:, None], self_term, 0)
    return out + self_term

"""Embedding lookup and per-node edge-type counts.

Port of molclr_tpu/ops/scatter_free.py (`embed_lookup` with its custom VJP,
`_counts`). The ELL gather aggregation of that module serves the `tile=0`
path, which the port does not have yet.
"""

from __future__ import annotations

import torch


class _EmbedLookup(torch.autograd.Function):
    """table[idx] whose backward is onehot(idx)^T @ g accumulated in f32
    (`_embed_bwd`): a matrix product instead of the scatter-add that
    PyTorch's own indexing backward runs with atomics on the card, so the
    table's gradient is the same bits on every run."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.num = table.shape[0]
        ctx.table_dtype = table.dtype
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        flat_g = g.reshape(-1, g.shape[-1])
        onehot = (idx.reshape(-1, 1) == torch.arange(
            ctx.num, device=idx.device)).to(flat_g.dtype)     # [M, num]
        dtable = onehot.t().float() @ flat_g.float()
        return dtable.to(ctx.table_dtype), None


def embed_lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx]; idx may be any shape. Differentiable in `table` with a
    deterministic one-hot-matmul backward."""
    return _EmbedLookup.apply(table, idx)


def _counts(idx: torch.Tensor, w: torch.Tensor, num: int) -> torch.Tensor:
    """cnt[n, t] = sum_k onehot(idx[n,k], t) * w[n,k] -> [N, num],
    accumulated slot by slot (no [N, K, num] intermediate). Out-of-range
    ids one-hot to zero, as jax.nn.one_hot does."""
    classes = torch.arange(num, device=idx.device)
    acc = None
    for k in range(idx.shape[1]):
        term = (idx[:, k, None] == classes).to(w.dtype) * w[:, k : k + 1]
        acc = term if acc is None else acc + term
    return acc

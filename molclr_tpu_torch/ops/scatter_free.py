"""Scatter-free embedding lookup and ELL neighborhood aggregation.

Port of molclr_tpu/ops/scatter_free.py: `embed_lookup`, `_counts`,
`_weighted_gather_sum`, `gine_aggregate` and `gcn_aggregate`, each
aggregation a torch.autograd.Function with the JAX custom VJP as its
backward. The aggregations serve the ELL trunk (`tile=0`): K accumulated
[N, D] row gathers, one per neighbor slot, plus one-hot count products for
the edge embeddings, with no [N, K, D] intermediate.

The backward passes rest on the packing contract of data/graphs.py: the
masked ELL adjacency, self-loop slot included, is symmetric (j is a live
neighbor of n iff n is one of j, with the same dis[n] * dis[j] weight), so
the adjoint of "gather the neighbors and sum" is the same gather applied to
the cotangent, and the tables' gradients are count-matrix products. No
backward here scatters (PyTorch's indexing backward and `index_add_`
accumulate floats with atomics on the card), so each run gives the same
bits.
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


def _weighted_gather_sum(h: torch.Tensor, nbr: torch.Tensor,
                         w: torch.Tensor) -> torch.Tensor:
    """sum_k w[:, k] * h[nbr[:, k]] as K accumulated [N, D] row gathers,
    each product and sum rounded in h's dtype."""
    acc = None
    for k in range(nbr.shape[1]):
        term = torch.index_select(h, 0, nbr[:, k]) \
            * w[:, k : k + 1].to(h.dtype)
        acc = term if acc is None else acc + term
    return acc


def _matmul(a: torch.Tensor, b: torch.Tensor, out_dtype) -> torch.Tensor:
    """a @ b accumulated in f32, cast to out_dtype."""
    return (a.float() @ b.float()).to(out_dtype)


class _GineAggregate(torch.autograd.Function):
    """The JAX `gine_aggregate` with its custom VJP (`_gine_bwd`)."""

    @staticmethod
    def forward(ctx, h, t_type, t_dir, nbr, bt, bd, mask):
        w = mask.to(h.dtype)
        out = _weighted_gather_sum(h, nbr, w)
        out = out + _matmul(_counts(bt, w, t_type.shape[0]),
                            t_type.to(h.dtype), h.dtype)
        out = out + _matmul(_counts(bd, w, t_dir.shape[0]),
                            t_dir.to(h.dtype), h.dtype)
        ctx.save_for_backward(nbr, bt, bd, mask)
        ctx.meta = (t_type.shape[0], t_dir.shape[0], h.dtype, t_type.dtype,
                    t_dir.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        nbr, bt, bd, mask = ctx.saved_tensors
        n_type, n_dir, h_dt, tt_dt, td_dt = ctx.meta
        # dh: the symmetric adjacency's gather of the cotangent
        dh = _weighted_gather_sum(g, nbr, mask.to(g.dtype)).to(h_dt)
        # the tables: cnt^T @ g in f32
        gf, wf = g.float(), mask.float()
        dt = _counts(bt, wf, n_type).t() @ gf
        dd = _counts(bd, wf, n_dir).t() @ gf
        return dh, dt.to(tt_dt), dd.to(td_dt), None, None, None, None


def gine_aggregate(h, t_type, t_dir, nbr, bt, bd, mask) -> torch.Tensor:
    """sum_k mask[n,k] * (h[nbr[n,k]] + t_type[bt[n,k]] + t_dir[bd[n,k]]).

    h [N, D]; t_type [T, D]; t_dir [R, D]; nbr / bt / bd / mask [N, K].
    Needs the symmetric packing contract (module docstring)."""
    return _GineAggregate.apply(h, t_type, t_dir, nbr, bt, bd, mask)


def _gcn_weights(mask, norm, dtype) -> torch.Tensor:
    w = mask.to(dtype)
    if norm is not None:
        w = w * norm.to(dtype)
    return w


class _GcnAggregate(torch.autograd.Function):
    """The JAX `gcn_aggregate` with its custom VJP (`_gcn_bwd`); norm gets
    no gradient, as there."""

    @staticmethod
    def forward(ctx, x, t_type, t_dir, nbr, bt, bd, mask, norm):
        w = _gcn_weights(mask, norm, x.dtype)
        out = _weighted_gather_sum(x, nbr, w)
        # the scalar edge term [N, 1]
        e = (_matmul(_counts(bt, w, t_type.shape[0]), t_type.to(x.dtype),
                     x.dtype)
             + _matmul(_counts(bd, w, t_dir.shape[0]), t_dir.to(x.dtype),
                       x.dtype))
        ctx.save_for_backward(nbr, bt, bd, mask, norm)
        ctx.meta = (t_type.shape[0], t_dir.shape[0], x.dtype, t_type.dtype,
                    t_dir.dtype)
        return out + e

    @staticmethod
    def backward(ctx, g):
        nbr, bt, bd, mask, norm = ctx.saved_tensors
        n_type, n_dir, x_dt, tt_dt, td_dt = ctx.meta
        dx = _weighted_gather_sum(g, nbr,
                                  _gcn_weights(mask, norm, g.dtype)).to(x_dt)
        # the scalar tables: dt[t] = sum_n cnt[n, t] * sum_d g[n, d]
        wf = _gcn_weights(mask, norm, torch.float32)
        gsum = g.float().sum(dim=-1, keepdim=True)           # [N, 1]
        dt = (_counts(bt, wf, n_type) * gsum).sum(dim=0)[:, None]
        dd = (_counts(bd, wf, n_dir) * gsum).sum(dim=0)[:, None]
        return (dx, dt.to(tt_dt), dd.to(td_dt), None, None, None, None,
                None)


def gcn_aggregate(x, t_type, t_dir, nbr, bt, bd, mask,
                  norm=None) -> torch.Tensor:
    """sum_k mask * norm * (x[nbr] + Emb1(bt) + Emb2(bd)) with the scalar
    edge tables t_type [T, 1], t_dir [R, 1]. norm [N, K] or None must be
    symmetric in (node, neighbor), as dis[n] * dis[j] is."""
    return _GcnAggregate.apply(x, t_type, t_dir, nbr, bt, bd, mask, norm)

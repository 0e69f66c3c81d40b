"""Masked segment reductions and graph pooling.

Port of molclr_tpu/ops/segment.py (`segment_sum`, `segment_mean`,
`segment_max`, `segment_softmax`, `graph_pool`). Every function takes an
explicit mask, so padded nodes and edges contribute nothing. Ids outside
[0, num_segments) are dropped, as JAX's segment ops drop them.

Nothing here scatters floats with atomics, so the card gives the same bits
on every run: sums are one-hot matrix products accumulated in f32 (their
backward is another product), the max is a scatter of `amax` (exact in any
order) whose backward gathers the cotangent and splits it equally among
the tied elements, the tie counts a one-hot product too.
"""

from __future__ import annotations

import torch

from molclr_tpu_torch.ops.scatter_free import embed_lookup

_NEG = -1e30


def _expand(mask: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (data.ndim - mask.ndim))


def _onehot(ids: torch.Tensor, num: int) -> torch.Tensor:
    """[N, num] f32 with a one at (n, ids[n]); rows of dropped ids zero."""
    return (ids[:, None] == torch.arange(num, device=ids.device)).float()


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, mask=None) -> torch.Tensor:
    """[N, ...] -> [num_segments, ...]: onehot(ids)^T @ data in f32, cast
    back to data's dtype."""
    if mask is not None:
        data = torch.where(_expand(mask, data), data, 0)
    flat = data.reshape(data.shape[0], -1).float()
    out = _onehot(segment_ids, num_segments).t() @ flat
    return out.reshape((num_segments,) + data.shape[1:]).to(data.dtype)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int, mask=None, counts=None) -> torch.Tensor:
    """Mean over segment members. `counts` overrides the denominator (e.g.
    graph_n_nodes); otherwise counts come from the mask and ids."""
    s = segment_sum(data, segment_ids, num_segments, mask)
    if counts is None:
        ones = torch.ones(data.shape[0], dtype=data.dtype,
                          device=data.device)
        counts = segment_sum(ones, segment_ids, num_segments, mask)
    counts = torch.clamp(counts, min=1).to(s.dtype)
    return s / counts.reshape(counts.shape + (1,) * (s.ndim - counts.ndim))


class _SegmentMax(torch.autograd.Function):
    """jax.ops.segment_max: the max of each segment, -inf where it is
    empty. Its backward is JAX's (`_scatter_extremal_jvp`): each element
    equal to its segment's max gets g * (1 / count) in data's dtype, count
    the number of such elements; the others get 0."""

    @staticmethod
    def forward(ctx, data, ids, num):
        n = data.shape[0]
        flat = data.reshape(n, -1)
        # dropped ids go to a spare row `num`, cut off below
        idx = torch.where((ids >= 0) & (ids < num), ids, num).long()
        out = torch.full((num + 1, flat.shape[1]), float("-inf"),
                         dtype=data.dtype, device=data.device)
        out = out.scatter_reduce(0, idx[:, None].expand_as(flat), flat,
                                 "amax", include_self=True)
        ctx.save_for_backward(flat, idx, out)
        ctx.shape = data.shape
        return out[:num].reshape((num,) + data.shape[1:])

    @staticmethod
    def backward(ctx, g):
        flat, idx, out = ctx.saved_tensors
        num = out.shape[0] - 1
        eq = flat == out[idx]                                  # [N, F]
        # counts: exact in f32 (up to 2^24 ties), the spare row's unused
        count = _onehot(idx, num + 1).t() @ eq.float()         # [num+1, F]
        coef = torch.where(eq, (1.0 / count.to(flat.dtype))[idx], 0)
        gf = torch.cat([g.reshape(num, -1),
                        g.new_zeros((1, flat.shape[1]))])
        return (gf[idx] * coef).reshape(ctx.shape), None, None


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, mask=None) -> torch.Tensor:
    """The masked max of each segment; 0 for a segment with no member (as
    PyG gives graphs with no nodes). Masked elements take -1e30 in data's
    dtype, which a segment's max of at most -5e29 (in that dtype) marks as
    empty."""
    if mask is not None:
        data = torch.where(_expand(mask, data), data, _NEG)
    out = _SegmentMax.apply(data, segment_ids, num_segments)
    return torch.where(out <= _NEG / 2, 0.0, out)


def _gather(values: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """values[ids] for values [S, ...], differentiable in values through
    embed_lookup's one-hot product."""
    flat = values.reshape(values.shape[0], -1)
    return embed_lookup(flat, ids).reshape(ids.shape + values.shape[1:])


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int, mask=None) -> torch.Tensor:
    """Numerically stable softmax within segments (the attention weights
    of a GlobalAttention pool). The ids must lie in [0, num_segments)."""
    if mask is not None:
        logits = torch.where(_expand(mask, logits), logits, _NEG)
    seg_max = _SegmentMax.apply(logits, segment_ids, num_segments)
    seg_max = torch.where(seg_max <= _NEG / 2, 0.0, seg_max)
    ex = torch.exp(logits - _gather(seg_max, segment_ids))
    if mask is not None:
        ex = torch.where(_expand(mask, ex), ex, 0.0)
    denom = segment_sum(ex, segment_ids, num_segments)
    return ex / _gather(torch.clamp(denom, min=1e-16), segment_ids)


def graph_pool(h: torch.Tensor, node_graph: torch.Tensor,
               node_mask: torch.Tensor, num_graphs: int,
               graph_n_nodes: torch.Tensor | None = None,
               method: str = "mean") -> torch.Tensor:
    """[N, D] -> [G, D]. sum and mean are a masked one-hot matmul in f32;
    mean matches PyG global_mean_pool: the denominator is the number of
    real atoms per graph (graph_n_nodes when given). max is segment_max
    over the real nodes (0 for an empty graph)."""
    if method == "max":
        return segment_max(h, node_graph, num_graphs, node_mask)
    if method not in ("add", "mean"):
        raise ValueError(f"unknown pool method {method!r}")
    graphs = torch.arange(num_graphs, device=h.device)
    a = (node_graph[:, None] == graphs).to(h.dtype)
    a = a * node_mask.to(h.dtype)[:, None]                 # [N, G]
    out = a.float().t() @ h.float()
    if method == "mean":
        if graph_n_nodes is None:
            counts = a.float().sum(dim=0)
        else:
            counts = graph_n_nodes.float()
        out = out / torch.clamp(counts, min=1.0)[:, None]
    return out.to(h.dtype)

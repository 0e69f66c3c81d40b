"""Data-parallel contrastive pretraining over torch.distributed ranks.

Port of molclr_tpu/parallel/dp.py. JAX runs one process per host and
shards a step over a mesh of its devices (`shard_map`); PyTorch runs one
process per GPU, so here each rank is one process on one device and the
mesh axis is the process group. Per step each rank does what the JAX
package's `_make_local_step` does on one device (dp.py:92-139):
  - its augmentation keys come from (seed, step, rank), as JAX folds the
    step and the device index into its key (the Pretrainer's streams);
  - MaskedBatchNorm sums its moments across the ranks before it turns
    them into the next affine (`SumAcrossRanks`, JAX's psum inside
    MaskedBatchNorm via bn_axis_name), in both BatchNorm modes;
  - both views' projections and the graph mask are gathered from every
    rank before the loss (`gather_rows`, JAX's all_gather), so NT-Xent's
    negatives span the global batch, for the closed form and K2f / K2b;
  - the gradients are averaged over the ranks (`mean_grads`, JAX's pmean)
    before the (replicated) Adam step.

The gradient is JAX's. Every rank computes the same global loss. JAX
transposes all_gather to psum_scatter and psum to psum, so rank r
receives the sum over all ranks of the cotangents of its own rows, world x
its share, and the pmean turns that into the exact gradient of the global
loss. Here the gather's backward all-reduces the cotangent and keeps the
rank's slice, and the moment sum's backward all-reduces its cotangent;
`mean_grads` then averages. (A plain dist.all_gather would cut the
autograd graph: the negatives of other ranks would give no gradient.)

Every collective of the step is an all_reduce (a sum), so one code path
runs on NCCL (production; capturable in a CUDA graph), on gloo on the CPU
(the tests) and on gloo over CUDA tensors (several ranks sharing one
card). The gather writes the rank's rows into a zeroed [world * B, ...]
buffer and sums: exact, since every element has one nonzero addend. At
world 1 every collective adds nothing, so the step is bit for bit the
one-card step; nothing skips the process group there.

Also here: each rank's share of a batch cache (`shard_batch_cache`: the
JAX package's multi-process contract, one device per process; a unit
stack's share is agreed where the Pretrainer plans it), and the per-rank
orders of an epoch
(`cache_orders`, `unit_orders`; the JAX Pretrainer's _dp_epoch_orders and
its DP units epoch, pretrain.py:974-1000, 1117-1130).

The node-row-sharded step (partition.py) runs this step's arithmetic on
each rank's segment of ONE giant batch; edgepart.py's aggregations gather
rows with `all_gather_rows`, the gather above without autograd.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from molclr_tpu_torch.data.regroup import epoch_unit_orders
from molclr_tpu_torch.losses import resolve_ntxent

# the JAX Pretrainer seeds device d's unit orders with seed + this * (d + 1)
UNIT_ORDER_STRIDE = 104729


class DPGroup:
    """One rank's view of the data-parallel group (the default
    torch.distributed process group): its rank, the world size, the
    backend and the device its collectives' tensors live on.
    `collectives` counts the all_reduce calls this rank has made and
    `reduced_bytes` the bytes of the buffers it handed them.

    A model holding one (its MaskedBatchNorm layers) deep-copies to a
    model holding the same group."""

    def __init__(self, rank: int, world: int, backend: str, device):
        self.rank, self.world, self.backend = int(rank), int(world), backend
        self.device = torch.device(device)
        self.collectives = 0
        self.reduced_bytes = 0

    def __deepcopy__(self, memo):
        return self

    def __repr__(self) -> str:
        return (f"DPGroup(rank={self.rank}, world={self.world}, "
                f"backend={self.backend!r}, device={self.device})")

    def all_reduce_(self, x: torch.Tensor, op=dist.ReduceOp.SUM
                    ) -> torch.Tensor:
        """Reduce x in place across the ranks (no autograd)."""
        dist.all_reduce(x, op=op)
        self.collectives += 1
        self.reduced_bytes += x.numel() * x.element_size()
        return x


class _SumAcrossRanks(torch.autograd.Function):
    """y = sum over ranks of x; its backward sums the cotangents (JAX
    transposes psum to psum)."""

    @staticmethod
    def forward(ctx, x, dp: DPGroup):
        ctx.dp = dp
        return dp.all_reduce_(x.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, g):
        return ctx.dp.all_reduce_(
            g.clone(memory_format=torch.contiguous_format)), None


class _GatherRows(torch.autograd.Function):
    """[B, ...] per rank -> [world * B, ...], rank r's rows at r * B; its
    backward sums the cotangent across the ranks and keeps the rank's rows
    (JAX transposes all_gather to psum_scatter)."""

    @staticmethod
    def forward(ctx, x, dp: DPGroup):
        b = x.shape[0]
        ctx.dp, ctx.rows = dp, (dp.rank * b, (dp.rank + 1) * b)
        return all_gather_rows(x, dp)

    @staticmethod
    def backward(ctx, g):
        g = ctx.dp.all_reduce_(g.clone(memory_format=torch.contiguous_format))
        return g[ctx.rows[0]: ctx.rows[1]], None


def all_gather_rows(x: torch.Tensor, dp: DPGroup) -> torch.Tensor:
    """[B, ...] per rank -> [world * B, ...], rank r's rows at r * B, with
    no autograd: the rank's rows written into a zeroed buffer, summed
    across the ranks (exact: every element has one nonzero addend)."""
    b = x.shape[0]
    buf = x.new_zeros((dp.world * b,) + tuple(x.shape[1:]))
    buf[dp.rank * b: (dp.rank + 1) * b] = x
    return dp.all_reduce_(buf)


def sum_across_ranks(x: torch.Tensor, dp: DPGroup) -> torch.Tensor:
    """The differentiable sum of x over the ranks."""
    return _SumAcrossRanks.apply(x, dp)


def gather_rows(x: torch.Tensor, dp: DPGroup) -> torch.Tensor:
    """The differentiable gather of every rank's x along its first axis,
    in rank order (every rank's x of one shape)."""
    return _GatherRows.apply(x, dp)


def gather_pairs(zis: torch.Tensor, zjs: torch.Tensor, pair_mask, dp: DPGroup):
    """Both views' projections [B, D] and the pair mask [B] of every rank,
    in rank order: ([world B, D], [world B, D], [world B]). The two views
    travel in one differentiable gather, stacked by rows, so that each
    view's cotangent comes back as a contiguous block, as from the
    one-card loss's own concatenation (at world 1 the step's bits are the
    one-card step's); the mask in a second gather, without a gradient."""
    b, d = zis.shape
    both = gather_rows(torch.cat([zis, zjs]), dp).view(dp.world, 2, b, d)
    mask = (torch.ones(b, device=zis.device) if pair_mask is None
            else pair_mask.to(zis.dtype))
    with torch.no_grad():
        masks = gather_rows(mask[:, None], dp)[:, 0] > 0
    return (both[:, 0].reshape(dp.world * b, d),
            both[:, 1].reshape(dp.world * b, d), masks)


def mean_grads(params, dp: DPGroup) -> None:
    """Average the parameters' gradients over the ranks, in place: one flat
    buffer in the parameters' order, summed and divided by the world size
    (JAX's pmean of the gradient tree). Parameters without a gradient are
    left out (every rank runs the same model, so they are the same
    ones)."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dp.all_reduce_(flat).div_(dp.world)
    at = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[at: at + n].view_as(g))
        at += n


def agree_ints(vals, dp: DPGroup, op: str = "max") -> tuple[int, ...]:
    """Small host integers agreed across the ranks: the elementwise max or
    min (the JAX package's multihost.agree_ints)."""
    t = torch.tensor([int(v) for v in vals], dtype=torch.int64,
                     device=dp.device)
    red = {"max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}[op]
    return tuple(int(x) for x in dp.all_reduce_(t, red).cpu())


def shard_batch_cache(batches: list, dp: DPGroup) -> tuple[list, int, int]:
    """This rank's share of its own packed batches (its corpus slice's):
    S = the fewest batches any rank has, so that every rank takes the same
    number of steps; the rank's remainder is dropped (drop_last at device
    granularity, multihost.shard_batch_cache_global). Returns (the kept
    batches, S, the number dropped)."""
    (s,) = agree_ints((len(batches),), dp, op="min")
    if s == 0:
        raise ValueError(f"a rank has no batches (this one {len(batches)})")
    return batches[:s], s, len(batches) - s


def cache_orders(order: np.ndarray, s: int) -> np.ndarray:
    """The rank's batch order of one epoch over its S cached batches: the
    iterator's shuffle of its batches with the dropped remainder left out
    (the JAX Pretrainer's _dp_epoch_orders for one local device)."""
    order = np.asarray(order)
    return order[order < s].astype(np.int64)


def unit_orders(n_units: int, units_per_batch: int, seed: int, rank: int,
                epoch: int, steps: int) -> np.ndarray:
    """Rank `rank`'s [S, T] unit rows of one epoch: epoch_unit_orders seeded
    with seed + 104729 (rank + 1), as the JAX Pretrainer seeds device
    `rank`, its first S = `steps` steps."""
    return epoch_unit_orders(n_units, units_per_batch,
                             seed + UNIT_ORDER_STRIDE * (rank + 1),
                             epoch)[:steps]


__all__ = ["DPGroup", "UNIT_ORDER_STRIDE", "agree_ints", "all_gather_rows",
           "cache_orders",
           "gather_pairs", "gather_rows", "mean_grads", "resolve_ntxent",
           "shard_batch_cache", "sum_across_ranks",
           "unit_orders"]

"""Node-row-sharded pretraining: ONE giant packed batch, split by node rows
across the ranks, trained with the single-card numerics.

Port of molclr_tpu/parallel/partition.py. The JAX package places a
`concat_shards` batch across a device mesh and runs the step under
`shard_map`; here each rank is one process holding only its segment (one
process per GPU, as parallel/dp.py):

  - `concat_shards` (data/graphs.py) renumbers S equal sub-batches into one
    global batch, so every field is S equal segments and rank r's share is
    segment r of each (`shard_graph_batch`, JAX's shard_graph_batch,
    partition.py:74-80).
  - The tile contract (no molecule crosses a tile, the rows per rank a
    tile multiple) keeps every neighbour id inside the rank's rows:
    `localize_shard` subtracts the rank's offsets and gives back a
    self-contained local batch (JAX's _localize / localize_shard,
    partition.py:46-72), which the tile-dense model trains with no
    collective in its aggregation (edgepart.local_tile_aggregate's
    computation, run by the model's own kernels K1f / K1b or K3f / K3b).
  - `partitioned_train_step` (JAX's build_partitioned_pretrain_step,
    partition.py:83-154) is train_step under dp on the localized shard:
    the BatchNorm moments summed across the ranks, NT-Xent on the gathered
    pairs, the gradients averaged, Adam; then the new running statistics
    averaged across the ranks (partition.py:139), one more all-reduce.

Its result is the single-card step on the whole batch: the same loss,
BatchNorm statistics and gradients (up to summation order), which lets a
batch larger than one card's memory train with unchanged numerics. It
differs from the data-parallel step only in its input contract (one
global-id batch, not one batch per rank); the arithmetic is the same.
"""

from __future__ import annotations

from dataclasses import fields

import numpy as np
import torch

from molclr_tpu_torch.data.graphs import GraphBatch, widen
from molclr_tpu_torch.parallel.dp import DPGroup
# (the module, not its names: train/pretrain.py imports parallel/)
from molclr_tpu_torch.train import pretrain as pretrain_lib


def _localize(batch: GraphBatch, i: int, s: int) -> GraphBatch:
    """Shard i of s of a concat_shards batch, as the segments of its
    fields (local sizes), with the renumbering undone: node, graph and
    bond ids shift back by i times the per-shard count and the global bond
    sentinel s * b maps to the local sentinel b (the inverse of
    concat_shards; JAX's _localize)."""
    n, g = batch.num_nodes, batch.num_graphs
    b = batch.bond_mask.shape[-1]

    def unshift_bond(x):
        return torch.where(x == s * b, b, x - i * b)

    out = {f.name: getattr(batch, f.name) for f in fields(GraphBatch)}
    for field, shift in (("node_graph", g), ("src", n), ("dst", n),
                         ("nbr", n), ("bond_graph", g)):
        out[field] = out[field] - i * shift
    for field in ("edge_bond", "nbr_bond"):
        out[field] = unshift_bond(out[field])
    return GraphBatch(**out)


def localize_shard(batch: GraphBatch, dp: DPGroup) -> GraphBatch:
    """This rank's segment of a concat_shards batch as a self-contained
    local batch (JAX's localize_shard)."""
    return _localize(batch, dp.rank, dp.world)


def shard_graph_batch(batch: GraphBatch, dp: DPGroup, device=None,
                      tile: int = 0) -> GraphBatch:
    """Rank dp.rank's segment of every field of a concat_shards batch
    (numpy arrays or torch tensors), as torch tensors on `device` (the
    rank's device by default), integers as int64 and masks as bool. Its
    ids stay global (localize_shard undoes them). Raises where a field's
    length does not split into dp.world equal segments, or (tile > 0)
    where the node rows per rank are not a multiple of the tile."""
    s, r = dp.world, dp.rank
    device = dp.device if device is None else device
    if tile > 0 and (batch.num_nodes // s) % tile:
        raise ValueError(f"{batch.num_nodes} node rows over {s} ranks: "
                         f"{batch.num_nodes / s} per rank, not a multiple "
                         f"of the tile {tile}")
    out = {}
    for f in fields(GraphBatch):
        x = getattr(batch, f.name)
        n = x.shape[0]
        if n % s:
            raise ValueError(f"{f.name}: {n} rows do not split into {s} "
                             f"equal segments")
        seg = x[r * (n // s): (r + 1) * (n // s)]
        if isinstance(seg, np.ndarray):
            seg = torch.from_numpy(np.array(seg))
        out[f.name] = widen(seg).to(device)
    return GraphBatch(**out)


@torch.no_grad()
def mean_running_stats(model, dp: DPGroup) -> None:
    """Average the model's floating-point buffers (the BatchNorm running
    mean and variance) over the ranks in place, in one all-reduce (JAX's
    pmean of the new batch_stats, partition.py:139): the sum times the
    f32 reciprocal of the world size, as XLA compiles pmean's division by
    a constant (the same bits as a division where the world is a power of
    two)."""
    bufs = [b for b in model.buffers() if b.is_floating_point()]
    if not bufs:
        return
    flat = torch.cat([b.reshape(-1) for b in bufs])
    dp.all_reduce_(flat).mul_(1.0 / dp.world)
    at = 0
    for b in bufs:
        b.copy_(flat[at: at + b.numel()].view_as(b))
        at += b.numel()


def partitioned_train_step(model, opt, batch_shard: GraphBatch, cfg,
                           step: int, lr: float | None, dp: DPGroup, *,
                           views=None, dropout_masks=None,
                           bond_window: int = 0, max_waves: int = 0,
                           return_grads: bool = False):
    """One optimizer step of the node-row-sharded giant batch on this rank
    (JAX's build_partitioned_pretrain_step's local step). batch_shard is
    this rank's segment of a concat_shards batch (shard_graph_batch),
    global ids; the model is built with dp (its BatchNorm sums the moments
    across the ranks) at cfg.model.tile. The views are drawn from
    step_generator(cfg.seed, TRAIN_STREAM, step, dp.rank) on the localized
    shard, as the data-parallel step draws them (JAX folds (step, device)
    into its key); views = (vi, vj) of the localized shard replaces the
    draw. With drop_ratio > 0 the dropout masks come from
    step_generator(cfg.seed, DROPOUT_STREAM, step, view, dp.rank) on the
    rank's device, as the data-parallel step draws them (JAX splits its
    dropout keys from the same folded key); dropout_masks (per view a list
    of this rank's [N, emb_dim] keep masks, one per layer, as train_step
    takes them) replaces the draw. Returns the global loss (the same on
    every rank); the parameters and running statistics leave the same on
    every rank.

    return_grads=True returns (loss, {name: averaged gradient}) with no
    update: the parameters, the optimizer and the running statistics are
    left as they were (JAX's return_grads)."""
    tile = cfg.model.tile
    if tile <= 0:
        raise ValueError("partitioned training requires tile-aligned "
                         "packing (model.tile > 0): the tile contract is "
                         "what makes aggregation collective-free")
    if batch_shard.num_nodes % tile:
        raise ValueError(f"{batch_shard.num_nodes} node rows on this rank, "
                         f"not a multiple of the tile {tile}")
    batch = localize_shard(batch_shard, dp)
    kw = dict(views=views, dropout_masks=dropout_masks,
              bond_window=bond_window, max_waves=max_waves, dp=dp,
              stream=(dp.rank,))
    if return_grads:
        saved = [b.clone() for b in model.buffers()]
        loss = pretrain_lib.forward_backward(model, opt, batch, cfg, step,
                                             **kw)
        with torch.no_grad():
            for b, v in zip(model.buffers(), saved):
                b.copy_(v)
        return loss.detach(), {k: p.grad.clone()
                               for k, p in model.named_parameters()
                               if p.grad is not None}
    loss = pretrain_lib.train_step(model, opt, batch, cfg, step, lr, **kw)
    mean_running_stats(model, dp)
    return loss


__all__ = ["localize_shard", "mean_running_stats", "partitioned_train_step",
           "shard_graph_batch"]

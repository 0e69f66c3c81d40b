"""Node-row-sharded GINE aggregation across the ranks.

Port of molclr_tpu/parallel/edgepart.py. One packed batch's node rows are
split into contiguous shards, one per rank; each rank holds its rows' ELL
in-edge lists with GLOBAL neighbour ids (`shard_ell_rows`). Three ways to
aggregate, in decreasing traffic:

1. `gine_aggregate_sharded` (edgepart.py:72-114): every rank's h gathered
   in each layer, a [N, D] buffer.
2. `gine_aggregate_halo` (edgepart.py:117-190): only H boundary rows
   exchanged with the two ring neighbours. Contiguous packing keeps each
   molecule inside [start - H, end + H) of the shard that holds its rows
   when H is at least the largest molecule's atom count.
3. `local_tile_aggregate` (edgepart.py:193-211): no collective. With
   tile-aligned packing and the rows per rank a tile multiple, no molecule
   crosses a shard, and aggregation is the tile-dense block-diagonal
   product of ops/tile_dense.py on the rank's rows alone. This is what
   the partitioned step (partition.py) runs, through the model's kernels.

The first two are torch.autograd.Functions whose backward is the JAX
custom VJP: by the symmetry of the packed adjacency (data/graphs.py), dh
for the rank's rows is the same gather applied to the gathered (or
halo-extended) cotangent, with no scatter. Their edge-table gradients are
the rank's local partials: JAX's shard_map transpose of a replicated input
sums them over the shards (edgepart.py:105-108); here the CALLER sums them
across the ranks (dp.all_reduce_ on the two tables' .grad). The tile
variant is plain autograd through local ops, as JAX differentiates it.

Every exchange is an all-reduce, the rule of parallel/dp.py: one code path
on NCCL, on gloo on the CPU and on gloo over CUDA tensors. The gather
writes the rank's rows into a zeroed [N, D] buffer (N D elements per
all-reduce). The halo exchange writes the rank's first and last H rows
into its neighbours' slots of a zeroed [S, 2, H, D] buffer (S 2 H D
elements, against the 2 H D that JAX's two ppermutes send); with S = 1
the neighbour is the rank itself, as JAX's perm [(0, 0)]. Every element
of either buffer has one nonzero addend, so the sums are exact.
"""

from __future__ import annotations

import torch

from molclr_tpu_torch.ops.scatter_free import _add_edge_terms, \
    _edge_table_grads, _weighted_gather_sum
from molclr_tpu_torch.ops.tile_dense import build_tile_adjacency, tile_matmul
from molclr_tpu_torch.parallel.dp import DPGroup, all_gather_rows

def shard_ell_rows(batch, n_shards: int) -> dict:
    """A packed batch's node-wise ELL arrays split into n_shards contiguous
    row shards, each with a leading shard axis (numpy arrays or torch
    tensors as given); nbr ids stay GLOBAL. The node count must divide
    evenly (choose the PadSpec so)."""
    n = batch.num_nodes
    if n % n_shards:
        raise ValueError(f"{n} nodes not divisible by {n_shards} shards")

    def split(x):
        return x.reshape((n_shards, n // n_shards) + tuple(x.shape[1:]))

    return {f: split(getattr(batch, f)) for f in (
        "nbr", "nbr_bond_type", "nbr_bond_dir", "nbr_mask", "node_mask")}


class _ShardedAggregate(torch.autograd.Function):
    """The gather variant with JAX's custom VJP (_shard_fwd / _shard_bwd,
    edgepart.py:86-111)."""

    @staticmethod
    def forward(ctx, h_local, t_type, t_dir, nbr, bt, bd, mask, dp):
        w = mask.to(h_local.dtype)
        out = _add_edge_terms(_weighted_gather_sum(
            all_gather_rows(h_local, dp), nbr, w), t_type, t_dir, bt, bd, w)
        ctx.save_for_backward(nbr, bt, bd, mask)
        ctx.dp = dp
        ctx.meta = (t_type.shape[0], t_dir.shape[0], h_local.dtype,
                    t_type.dtype, t_dir.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        nbr, bt, bd, mask = ctx.saved_tensors
        n_type, n_dir, h_dt, tt_dt, td_dt = ctx.meta
        g = g.contiguous()
        # dh for the rank's rows: the local gather of the gathered
        # cotangent (symmetry)
        dh = _weighted_gather_sum(all_gather_rows(g, ctx.dp), nbr,
                                  mask.to(g.dtype)).to(h_dt)
        dt, dd = _edge_table_grads(g, bt, bd, mask, n_type, n_dir)
        return (dh, dt.to(tt_dt), dd.to(td_dt), None, None, None, None,
                None)


def gine_aggregate_sharded(h_local, t_type, t_dir, nbr, bt, bd, mask,
                           dp: DPGroup) -> torch.Tensor:
    """GINE aggregation of this rank's rows with every rank's h gathered:
    h_local [n_local, D]; the ELL arrays [n_local, K] with global neighbour
    ids. One all-reduce of [N, D] forward and one backward. The tables'
    gradients are this rank's partials: sum them across the ranks."""
    return _ShardedAggregate.apply(h_local, t_type, t_dir, nbr, bt, bd, mask,
                                   dp)


def _halo_extend(x, halo: int, dp: DPGroup) -> torch.Tensor:
    """[n_local, D] -> [halo + n_local + halo, D]: the left neighbour's last
    `halo` rows, the rank's rows, the right neighbour's first `halo` rows
    (ring neighbours; the wrap-around rows of the first and last rank are
    another shard's, unreachable under the packing contract)."""
    s, r = dp.world, dp.rank
    buf = x.new_zeros((s, 2, halo) + tuple(x.shape[1:]))
    buf[(r + 1) % s, 0] = x[-halo:]
    buf[(r - 1) % s, 1] = x[:halo]
    dp.all_reduce_(buf)
    return torch.cat([buf[r, 0], x, buf[r, 1]])


def _halo_index(nbr, mask, n_local: int, halo: int, dp: DPGroup):
    """Global neighbour ids -> rows of the halo-extended block. Masked
    slots go to row 0 (their weight is 0). A live slot outside the window
    breaks the packing contract: index_select then raises (CPU) or reads
    out of bounds (CUDA); JAX's take gives NaN there."""
    start = dp.rank * n_local
    return torch.where(mask, nbr - start + halo, torch.zeros_like(nbr))


class _HaloAggregate(torch.autograd.Function):
    """The halo variant with JAX's custom VJP (_halo_fwd / _halo_bwd,
    edgepart.py:158-187)."""

    @staticmethod
    def forward(ctx, h_local, t_type, t_dir, nbr, bt, bd, mask, dp, halo):
        n_local = h_local.shape[0]
        if not 0 < halo <= n_local:
            raise ValueError(f"halo {halo} outside (0, {n_local}], the "
                             f"rows of a rank")
        w = mask.to(h_local.dtype)
        idx = _halo_index(nbr, mask, n_local, halo, dp)
        out = _add_edge_terms(_weighted_gather_sum(
            _halo_extend(h_local, halo, dp), idx, w), t_type, t_dir, bt, bd,
            w)
        ctx.save_for_backward(idx, bt, bd, mask)
        ctx.dp, ctx.halo = dp, halo
        ctx.meta = (t_type.shape[0], t_dir.shape[0], h_local.dtype,
                    t_type.dtype, t_dir.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        idx, bt, bd, mask = ctx.saved_tensors
        n_type, n_dir, h_dt, tt_dt, td_dt = ctx.meta
        g = g.contiguous()
        dh = _weighted_gather_sum(_halo_extend(g, ctx.halo, ctx.dp), idx,
                                  mask.to(g.dtype)).to(h_dt)
        dt, dd = _edge_table_grads(g, bt, bd, mask, n_type, n_dir)
        return (dh, dt.to(tt_dt), dd.to(td_dt), None, None, None, None,
                None, None)


def gine_aggregate_halo(h_local, t_type, t_dir, nbr, bt, bd, mask,
                        dp: DPGroup, halo: int) -> torch.Tensor:
    """GINE aggregation of this rank's rows with `halo` boundary rows
    exchanged with each ring neighbour (halo >= the largest molecule's atom
    count, <= the rows per rank). The backward halo-extends the cotangent.
    One all-reduce of [S, 2, halo, D] forward and one backward. The
    tables' gradients are this rank's partials: sum them across the
    ranks."""
    return _HaloAggregate.apply(h_local, t_type, t_dir, nbr, bt, bd, mask,
                                dp, halo)


def local_tile_aggregate(h_local, t_type, t_dir, nbr, bt, bd, mask,
                         dp: DPGroup, tile: int) -> torch.Tensor:
    """Collective-free GINE aggregation of this rank's rows: tile-aligned
    packing with n_local % tile == 0, so every neighbour is on the rank.
    The rank's start is subtracted from the global ids, then the
    block-diagonal adjacency product and the edge-count products run on
    the local rows (autograd; dp.collectives does not move). The tables'
    gradients are this rank's partials: sum them across the ranks."""
    n_local = h_local.shape[0]
    if tile <= 0 or n_local % tile:
        raise ValueError(f"{n_local} rows per rank, not a multiple of the "
                         f"tile {tile}")
    local = torch.where(mask, nbr - dp.rank * n_local, torch.zeros_like(nbr))
    adj = build_tile_adjacency(local, mask, tile, dtype=h_local.dtype)
    return _add_edge_terms(tile_matmul(adj, h_local), t_type, t_dir, bt, bd,
                           mask.to(h_local.dtype))


def build_sharded_layer(dp: DPGroup, variant: str = "gather", halo: int = 0,
                        tile: int = 0):
    """This rank's sharded aggregation, layer(h_local, t_type, t_dir, nbr,
    bt, bd, mask) on its row shard (JAX's build_sharded_layer without the
    mesh: each rank calls it on its own rows). variant 'gather' (any
    packing), 'halo' (halo >= the largest molecule's atom count) or 'tile'
    (collective-free; tile-aligned packing, the rows per rank a tile
    multiple)."""
    if variant == "gather":
        return lambda *a: gine_aggregate_sharded(*a, dp)
    if variant == "halo":
        return lambda *a: gine_aggregate_halo(*a, dp, halo)
    if variant == "tile":
        return lambda *a: local_tile_aggregate(*a, dp, tile)
    raise ValueError(f"unknown variant {variant!r}")


__all__ = ["build_sharded_layer", "gine_aggregate_halo",
           "gine_aggregate_sharded", "local_tile_aggregate",
           "shard_ell_rows"]

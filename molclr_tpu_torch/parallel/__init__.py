"""Pretraining over torch.distributed ranks, one process per GPU: the port
of molclr_tpu/parallel/.

- dp.py, multihost.py: data parallelism, one batch per rank (JAX's
  build_dp_pretrain_step and its multi-process helpers).
- partition.py: ONE giant concat_shards batch split by node rows across
  the ranks, trained with the single-card numerics
  (`partitioned_train_step`, JAX's build_partitioned_pretrain_step,
  partition.py:83-154).
- edgepart.py: node-row-sharded GINE aggregation, three ways (JAX's
  edgepart.py): every rank's h gathered (`gine_aggregate_sharded`,
  :72-114), H boundary rows exchanged with the ring neighbours
  (`gine_aggregate_halo`, :117-190), or no collective under the tile
  contract (`local_tile_aggregate`, :193-211).
"""

from molclr_tpu_torch.parallel.dp import (
    DPGroup,
    agree_ints,
    all_gather_rows,
    cache_orders,
    gather_pairs,
    gather_rows,
    mean_grads,
    resolve_ntxent,
    shard_batch_cache,
    sum_across_ranks,
    unit_orders,
)
from molclr_tpu_torch.parallel.multihost import (
    corpus_shard_range,
    destroy_distributed,
    init_distributed,
)
from molclr_tpu_torch.parallel.partition import (
    localize_shard,
    mean_running_stats,
    partitioned_train_step,
    shard_graph_batch,
)
from molclr_tpu_torch.parallel.edgepart import (
    build_sharded_layer,
    gine_aggregate_halo,
    gine_aggregate_sharded,
    local_tile_aggregate,
    shard_ell_rows,
)

__all__ = ["DPGroup", "agree_ints", "all_gather_rows", "build_sharded_layer",
           "cache_orders", "corpus_shard_range", "destroy_distributed",
           "gather_pairs", "gather_rows", "gine_aggregate_halo",
           "gine_aggregate_sharded", "init_distributed",
           "local_tile_aggregate", "localize_shard", "mean_grads",
           "mean_running_stats", "partitioned_train_step", "resolve_ntxent",
           "shard_batch_cache", "shard_ell_rows", "shard_graph_batch",
           "sum_across_ranks", "unit_orders"]

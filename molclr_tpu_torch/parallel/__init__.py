"""Data-parallel pretraining over torch.distributed ranks: the port of
molclr_tpu/parallel/ (dp.py, multihost.py), one process per GPU. The
node-row-sharded giant-batch step (partition.py, edgepart.py) is not
ported yet."""

from molclr_tpu_torch.parallel.dp import (
    DPGroup,
    agree_ints,
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

__all__ = ["DPGroup", "agree_ints", "cache_orders", "corpus_shard_range",
           "destroy_distributed", "gather_pairs", "gather_rows",
           "init_distributed", "mean_grads", "resolve_ntxent",
           "shard_batch_cache", "sum_across_ranks",
           "unit_orders"]

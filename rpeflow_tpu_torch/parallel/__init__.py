"""Data parallelism over ``torch.distributed`` (counterpart of
rpeflow_tpu.parallel); ``parallel.dryrun`` runs one data-parallel train step
over n CPU processes."""

from .mesh import (
    all_reduce_,
    all_reduce_grads,
    all_reduce_sum,
    barrier,
    maybe_initialize_distributed,
    process_count,
    process_index,
    replicate,
    shard_batch,
)

__all__ = ["all_reduce_", "all_reduce_grads", "all_reduce_sum", "barrier",
           "maybe_initialize_distributed", "process_count", "process_index", "replicate",
           "shard_batch"]

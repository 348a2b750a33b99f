"""partitionedhashjoin_tpu — a vectorized query-execution engine in JAX.

A JAX/XLA implementation of the capabilities of the reference
C++ benchmark suite ``ragoragino/partitionedhashjoin`` (the Blanas SIGMOD'11
no-partitioning and radix-partitioning main-memory hash joins), extended to a
fuller kernel suite (radix sort, filter, hash aggregate) and to multi-chip
execution over a ``jax.sharding.Mesh``.  It runs on NVIDIA GPUs (and on
the CPU for tests).

Architecture (not a translation of the reference's C++):

- The reference's latched pointer-chasing hash tables (src/HashTables/) become
  *sorted-array* tables probed by vectorized binary search: one-key sorts go
  to the GPU's radix sort, and a sorted build run of 10M keys stays resident
  in the H100's L2 during the probe.  Conflict freedom is by construction,
  exactly like the reference's scatter phase
  (src/RadixCluster/HashJoin.hpp:394-412) but for every phase.
- The reference's thread pool (src/Common/ThreadPool.*) becomes XLA: a single
  jitted program *is* the staged pipeline; multi-chip parallelism uses
  ``shard_map`` + collectives instead of worker threads.
- The reference's cache/TLB-conscious radix fan-out (src/RadixCluster/) becomes
  range-radix clustering by sorting: every partition is a contiguous key range
  of the sorted relation.
"""

from partitionedhashjoin_tpu import config
from partitionedhashjoin_tpu.config import (
    Configuration,
    JoinAlgorithmType,
    OutputType,
    ResultsFormat,
)
from partitionedhashjoin_tpu.data.table import Table

__version__ = "0.1.0"

__all__ = [
    "Configuration",
    "JoinAlgorithmType",
    "OutputType",
    "ResultsFormat",
    "Table",
    "config",
]


def __getattr__(name):
    """Lazy convenience exports (joiners import jax; keep package import light)."""
    lazy = {
        "SortMergeJoiner": ("partitionedhashjoin_tpu.ops.sort_merge", "SortMergeJoiner"),
        "NoPartitioningHashJoiner": (
            "partitionedhashjoin_tpu.ops.no_partitioning",
            "NoPartitioningHashJoiner",
        ),
        "RadixHashJoiner": (
            "partitionedhashjoin_tpu.ops.radix_cluster",
            "RadixHashJoiner",
        ),
        "DistributedShuffleJoiner": (
            "partitionedhashjoin_tpu.parallel.shuffle",
            "DistributedShuffleJoiner",
        ),
        "sequential_table": (
            "partitionedhashjoin_tpu.ops.generators",
            "sequential_table",
        ),
        "zipf_table": ("partitionedhashjoin_tpu.ops.generators", "zipf_table"),
        "hash_aggregate": (
            "partitionedhashjoin_tpu.ops.aggregate",
            "hash_aggregate",
        ),
        "filter_table": ("partitionedhashjoin_tpu.ops.filter", "filter_table"),
        "sort_table": ("partitionedhashjoin_tpu.ops.sort", "sort_table"),
        "radix_sort_table": (
            "partitionedhashjoin_tpu.ops.sort",
            "radix_sort_table",
        ),
        "scan": ("partitionedhashjoin_tpu.query", "scan"),
        "Query": ("partitionedhashjoin_tpu.query", "Query"),
        "execute_sql": ("partitionedhashjoin_tpu.sql", "execute_sql"),
        "explain_sql": ("partitionedhashjoin_tpu.sql", "explain_sql"),
    }
    if name in lazy:
        import importlib

        module, attr = lazy[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'partitionedhashjoin_tpu' has no attribute {name!r}")

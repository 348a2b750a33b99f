"""Radix-partitioning hash join (Blanas SIGMOD'11, algorithm 2).

Counterpart of src/RadixCluster/HashJoin.hpp:91-440:

- **Partition phase** (HashJoin.hpp:333-440): both relations fanned out into P
  contiguous partitions by ``hash(key) & (P-1)`` — here the sort-based
  pipeline in ops/radix.py, run for A and B (the reference runs them
  concurrently on the thread pool, :210-213; XLA schedules both sorts inside
  one jit).
- **Join phase** (HashJoin.hpp:243-331): the reference loops workers over
  partitions round-robin, building a fresh hash table per partition (:278)
  and probing it (:295-301).  Here every partition's chained table lives in
  one flat bucket space (bucket = partition offset + in-partition hash) and
  ALL per-partition builds collapse into ONE stable sort
  (ops/hash_table.py::build_chained_from_buckets); probes walk contiguous
  chains with windowed gathers, chunked per dispatch at scale —
  partition-parallelism becomes data parallelism.

Match semantics are the reference's: each probe row counts once if its key
exists in the same partition's build table (``Get`` != null, :295-301).
The partition hasher and the bucket hasher are decorrelated by seed
(src/main.cpp:215-217,267): we derive both from one base seed via distinct
mix constants.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from partitionedhashjoin_tpu.config import RadixClusteringConfiguration
from partitionedhashjoin_tpu.data.table import Table
from partitionedhashjoin_tpu.ops import hash_table as ht
from partitionedhashjoin_tpu.ops import radix
from partitionedhashjoin_tpu.utils.logger import get_new_logger
from partitionedhashjoin_tpu.utils.results import IHashJoinTimer, NoOpHashJoinTimer

#: Seed decorrelation constants: partition hash vs bucket hash must be
#: independent or every sub-table sees only keys whose low hash bits are
#: equal (main.cpp:215-217,267 uses two randomly seeded XXHashers).
_PARTITION_SEED_MIX = 0x9E3779B9
_BUCKET_SEED_MIX = 0x85EBCA6B

#: Mode that "auto" resolves to: the faster of the two at 10M ⋈ 200M on
#: the H100 (PERF.md, path decisions).
AUTO_MODE = "vmem"


@jax.jit
def _sort_both(a, b):
    """The vmem mode's fan-out: one program sorting both relations, like
    the reference running both partition jobs concurrently on the pool
    (HashJoin.hpp:210-213)."""
    return (
        jax.lax.sort((a,), num_keys=1, is_stable=False)[0],
        jax.lax.sort((b,), num_keys=1, is_stable=False)[0],
    )


@functools.partial(jax.jit, static_argnames=("num_partitions", "passes"))
def _partition_both(
    keys_a, keys_b, part_seed, num_partitions: int, passes: int = 1
):
    """Key-only fan-out of both relations (HashJoin.hpp:210-213 runs them
    concurrently on the pool; XLA schedules both sorts in one program).
    Payloads are not carried — the join only counts (Readme.md:10)."""
    keys_a_part, hist_a, _ = radix.radix_partition_keys(
        keys_a, part_seed, num_partitions, passes=passes
    )
    keys_b_part, _, _ = radix.radix_partition_keys(
        keys_b, part_seed, num_partitions, passes=passes
    )
    return keys_a_part, hist_a, keys_b_part


def _segment_bucket_ids(keys, part_seed, bucket_seed, boff, bcnt, num_partitions):
    """Global bucket id: partition's bucket-range offset + in-partition hash
    bucket (the per-partition ``factory.New(|A_p|)`` table geometry,
    RadixCluster/HashJoin.hpp:278, flattened into one bucket space)."""
    from partitionedhashjoin_tpu.ops import hashing

    pid = radix.partition_ids(keys, part_seed, num_partitions)
    h = hashing.hash32(keys, bucket_seed)
    local = (h % bcnt[pid].astype(jnp.uint32)).astype(jnp.int32)
    return boff[pid] + local


@functools.partial(jax.jit, static_argnames=("num_buckets", "num_partitions"))
def _build_phase(
    keys_a_part,
    hist_a,
    part_seed,
    bucket_seed,
    num_buckets: int,
    num_partitions: int,
):
    """Per-partition chained tables in one flat bucket space, built with ONE
    stable sort (the per-partition insert loops of HashJoin.hpp:283-286
    collapse into it).  Bucket count per partition ~= |A_p| (load <= 1)."""
    boff, bcnt = ht.segment_geometry(hist_a, ratio=1.0)
    bucket = _segment_bucket_ids(
        keys_a_part, part_seed, bucket_seed, boff, bcnt, num_partitions
    )
    table = ht.build_chained_from_buckets(
        bucket, keys_a_part, bucket_seed, num_buckets
    )
    return table, boff, bcnt


@functools.partial(jax.jit, static_argnames=("num_partitions",))
def _probe_chunk(
    table: ht.ChainedHashTable,
    keys,
    part_seed,
    boff,
    bcnt,
    num_partitions: int,
    skip=None,
) -> jax.Array:
    bucket = _segment_bucket_ids(
        keys, part_seed, table.seed, boff, bcnt, num_partitions
    )
    return ht._probe_chained_count_chunk(table, keys, bucket, skip=skip)


def _probe_phase(
    table: ht.ChainedHashTable,
    keys_b_part,
    part_seed,
    boff,
    bcnt,
    num_partitions: int,
    num_chunks: int = 1,
) -> jax.Array:
    """Chunked at the DISPATCH level, not with lax.map: each chunk is its own
    XLA program, so separate dispatches bound both program runtime and
    temporaries.

    Non-divisible ``n`` chunks via overlapping windows + a traced ``skip``
    mask (see ops/hash_table.py::probe_chained_count) — prime-sized probes
    no longer collapse to one relation-sized dispatch."""
    n = keys_b_part.shape[0]
    num_chunks = min(num_chunks, max(1, n))
    if num_chunks <= 1:
        return _probe_chunk(
            table, keys_b_part, part_seed, boff, bcnt, num_partitions
        )
    m = -(-n // num_chunks)
    total = None
    for c in range(num_chunks):
        start = min(c * m, n - m)
        skip = c * m - start
        cnt = _probe_chunk(
            table,
            jax.lax.dynamic_slice(keys_b_part, (start,), (m,)),
            part_seed,
            boff,
            bcnt,
            num_partitions,
            skip=jnp.asarray(skip, jnp.int32),
        )
        total = cnt if total is None else total + cnt
    return total


class RadixHashJoiner:
    """Driver mirroring RadixCluster::HashJoiner (HashJoin.hpp:91-135).

    ``run`` = partition A ∥ partition B → build → probe → count
    (HashJoin.hpp:190-241), with each phase a fused XLA program ended by
    ``block_until_ready`` for exact timer attribution.
    """

    def __init__(
        self,
        configuration: Optional[RadixClusteringConfiguration] = None,
        seed: Optional[int] = None,
    ) -> None:
        self._config = configuration or RadixClusteringConfiguration()
        p = self._config.number_of_partitions
        if p & (p - 1):
            raise ValueError(f"number_of_partitions must be a power of 2, got {p}")
        if seed is None:
            import numpy as _np

            seed = int(_np.random.SeedSequence().entropy & 0xFFFFFFFF)
        self._part_seed = jnp.asarray(
            (seed ^ _PARTITION_SEED_MIX) & 0xFFFFFFFF, jnp.uint32
        )
        self._bucket_seed = jnp.asarray(
            (seed ^ _BUCKET_SEED_MIX) & 0xFFFFFFFF, jnp.uint32
        )
        self._logger = get_new_logger("RadixClusterHashJoiner")

    @property
    def num_partitions(self) -> int:
        return self._config.number_of_partitions

    def run(
        self,
        table_a: Table,
        table_b: Table,
        timer: Optional[IHashJoinTimer] = None,
    ) -> int:
        """Partition both, build, probe, return count.

        Mode "vmem" is range-radix clustering + a binary-search probe of
        the sorted build run; "chained" is the reference-structured hash
        fan-out + chained tables (see
        config.RadixClusteringConfiguration.mode).
        """
        mode = getattr(self._config, "mode", "auto")
        if mode == "auto":
            mode = AUTO_MODE
        if mode == "vmem":
            return self._run_vmem(table_a, table_b, timer)
        if mode != "chained":
            raise ValueError(f"unknown radix mode {mode!r}")
        timer = timer or NoOpHashJoinTimer()
        p = self.num_partitions

        timer.set_partitioning_phase_begin()
        keys_a_part, hist_a, keys_b_part = _partition_both(
            table_a.keys,
            table_b.keys,
            self._part_seed,
            p,
            passes=self._config.partition_passes,
        )
        jax.block_until_ready((keys_a_part, keys_b_part))
        timer.set_partitioning_phase_end()

        num_buckets = ht.segmented_capacity(table_a.size, p, ratio=1.0)
        timer.set_build_phase_begin()
        chained, boff, bcnt = _build_phase(
            keys_a_part, hist_a, self._part_seed, self._bucket_seed,
            num_buckets, p,
        )
        jax.block_until_ready(chained.entry_rows)
        timer.set_build_phase_end()

        timer.set_probe_phase_begin()
        count = _probe_phase(
            chained,
            keys_b_part,
            self._part_seed,
            boff,
            bcnt,
            p,
            num_chunks=ht.dispatch_chunks(table_b.size),
        )
        count = int(jax.device_get(count))
        timer.set_probe_phase_end()
        self._logger.info("Number of joined tuples: %d", count)
        return count

    def _run_vmem(
        self,
        table_a: Table,
        table_b: Table,
        timer: Optional[IHashJoinTimer] = None,
    ) -> int:
        """Range-radix + binary-search probe of the sorted build run
        (ops/merge_join.py).

        Phase mapping onto the reference timer (HashJoin.hpp:190-241):

        - partition: one UNstable 1-key sort per relation.  Sorting by key
          IS range-radix clustering — every partition is a contiguous key
          range, laid out contiguously, exactly what the reference's scatter
          produces per hash partition (:394-412).  ``number_of_partitions``
          is advisory here: the search ranges every probe key individually,
          a finer fan-out than any practical P.
        - build: nothing to build — the sorted build side IS the lookup
          structure.
        - probe: one vectorized binary search per probe row; the sorted
          probe order makes neighbouring searches read neighbouring build
          positions, and a 10M-row build run stays resident in L2.
        """
        from partitionedhashjoin_tpu.ops import merge_join

        timer = timer or NoOpHashJoinTimer()

        # int64 keys keep their width: truncation would make distinct
        # 64-bit keys collide (round-2 review; same contract as
        # hash_table's _as_i32_keys, which the chained mode inherits).
        a_keys = jnp.asarray(table_a.keys)
        b_keys = jnp.asarray(table_b.keys)
        wide = (jnp.int64, jnp.uint64)
        use_i64 = a_keys.dtype in wide or b_keys.dtype in wide
        dtype = jnp.int64 if use_i64 else jnp.int32

        timer.set_partitioning_phase_begin()
        a_sorted, b_sorted = _sort_both(
            a_keys.astype(dtype), b_keys.astype(dtype)
        )
        jax.block_until_ready((a_sorted, b_sorted))
        timer.set_partitioning_phase_end()

        timer.set_build_phase_begin()
        timer.set_build_phase_end()

        timer.set_probe_phase_begin()
        count = merge_join.sorted_runs_count(a_sorted, b_sorted)
        count = int(jax.device_get(count))
        timer.set_probe_phase_end()
        self._logger.info("Number of joined tuples: %d", count)
        return count

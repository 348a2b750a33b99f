"""Radix partitioning: histogram → prefix sum → scatter.

Counterpart of the reference's 3-stage partition pipeline
(src/RadixCluster/HashJoin.hpp:333-440): stage 1 builds per-worker histograms
of ``hash(key) % P`` (:343-357), stage 2 turns them into per-partition
exclusive prefix sums / global boundaries (:360-390, PartitionsInfo :16-33),
stage 3 scatters each tuple to ``boundary[p].start + cursor[p][w]++`` (:394-412).

Here the per-worker cursor trick is a stable *rank within partition*; the
whole pipeline collapses to:

    pid       = hash(key) & (P-1)                  (stage 1's hash)
    histogram = scatter-add one-hot(pid)           (stage 1)
    offsets   = exclusive cumsum(histogram)        (stage 2)
    order     = stable argsort(pid)                (stage 3: rank + scatter)

A stable sort by an int32 partition id is exactly "scatter every row to its
partition region preserving arrival order" — conflict-free by construction,
like the reference's scatter, and it maps to XLA's native sort instead of
serialized random scatters.  ``radix_partition_padded`` additionally rounds
each partition up to a block multiple so downstream consumers can walk
fixed-size tiles that never straddle a partition boundary (the analogue of
the reference's cache/TLB-conscious fan-out).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from partitionedhashjoin_tpu.ops import hashing


def partition_ids(keys: jax.Array, seed, num_partitions: int) -> jax.Array:
    """``hash(key) % P`` partition assignment (HashJoin.hpp:349-350,401-402).

    P must be a power of two so the reduction is a mask (the reference allows
    any P but only ever benchmarks powers of two, scripts/generate.sh:77).
    """
    if num_partitions & (num_partitions - 1):
        raise ValueError(f"num_partitions must be a power of 2, got {num_partitions}")
    h = hashing.hash32(keys, seed)
    return (h & jnp.uint32(num_partitions - 1)).astype(jnp.int32)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class PartitionedRelation:
    """A relation scattered into contiguous partitions.

    Counterpart of the partitioned output table + ``PartitionsInfo``
    boundaries (HashJoin.hpp:16-33).  ``offsets[p]`` is the start of partition
    p (exclusive prefix sum of ``histogram``); partition p occupies rows
    ``offsets[p] : offsets[p] + histogram[p]``.  For the padded variant,
    stride rows between ``histogram[p]`` and the next offset are invalid
    (``row_ids`` holds -1 there).
    """

    keys: jax.Array  # int32[m]   partition-contiguous keys
    payloads: jax.Array  # int32[m]   payloads, same order
    row_ids: jax.Array  # int32[m]   original row index, -1 = padding
    histogram: jax.Array  # int32[P]   true partition sizes
    offsets: jax.Array  # int32[P]   partition start offsets

    @property
    def num_partitions(self) -> int:
        return self.histogram.shape[0]


@functools.partial(jax.jit, static_argnames=("num_partitions",))
def radix_partition(
    keys: jax.Array,
    payloads: jax.Array,
    seed,
    num_partitions: int,
) -> PartitionedRelation:
    """Single-pass fan-out into P contiguous partitions (dense, no padding)."""
    n = keys.shape[0]
    pid = partition_ids(keys, seed, num_partitions)
    histogram = jnp.zeros((num_partitions,), jnp.int32).at[pid].add(1)
    offsets = jnp.cumsum(histogram) - histogram
    row_ids = jnp.arange(n, dtype=jnp.int32)
    _, keys_s, pay_s, rows_s = jax.lax.sort(
        (pid, keys, payloads, row_ids), num_keys=1, is_stable=True
    )
    return PartitionedRelation(
        keys=keys_s,
        payloads=pay_s,
        row_ids=rows_s,
        histogram=histogram,
        offsets=offsets,
    )


@functools.partial(jax.jit, static_argnames=("num_partitions", "passes"))
def radix_partition_keys(
    keys: jax.Array, seed, num_partitions: int, passes: int = 1
):
    """Key-only fan-out: (partitioned_keys, histogram, offsets).

    The count-join path needs no payloads or row ids (dense partitioning has
    no padding), and dropping them shrinks the partition sort from four
    operands to two — at 200M rows that halves the sort's peak device
    memory.

    ``passes > 1`` runs the multi-pass radix cluster (Manegold 2002 /
    Balkesen ICDE'13; the reference stays single-pass, SURVEY.md §3.4): LSD
    passes over ``log2(P)/passes``-bit digits of the partition id, each pass
    a stable digit sort, yielding a layout identical to the single-pass
    fan-out.  On CPUs multi-pass bounds per-pass TLB/cache fan-out; here
    each pass's sort key is narrower — the knob exists for parity and for
    backends where narrow-key passes win.
    """
    pid = partition_ids(keys, seed, num_partitions)
    histogram = jnp.zeros((num_partitions,), jnp.int32).at[pid].add(1)
    offsets = jnp.cumsum(histogram) - histogram
    bits = max(1, num_partitions.bit_length() - 1)
    if passes <= 1 or bits <= 1:
        _, keys_s = jax.lax.sort((pid, keys), num_keys=1, is_stable=True)
        return keys_s, histogram, offsets
    passes = min(passes, bits)
    bits_per_pass = -(-bits // passes)
    digit_mask = jnp.int32((1 << bits_per_pass) - 1)
    keys_s, pid_s = keys, pid
    for p in range(passes):  # LSD: low digits first; stability composes
        digit = (pid_s >> jnp.int32(p * bits_per_pass)) & digit_mask
        _, keys_s, pid_s = jax.lax.sort(
            (digit, keys_s, pid_s), num_keys=1, is_stable=True
        )
    return keys_s, histogram, offsets


@functools.partial(jax.jit, static_argnames=("num_partitions", "block_rows"))
def radix_partition_padded(
    keys: jax.Array,
    payloads: jax.Array,
    seed,
    num_partitions: int,
    block_rows: int,
) -> PartitionedRelation:
    """Fan-out with every partition padded to a multiple of ``block_rows``.

    Output capacity is the static worst case n_padded = n rounded up by one
    block per partition, so tile walkers can assume tiles never straddle
    partitions.  Padding rows carry ``row_ids == -1`` and key 0.
    """
    n = keys.shape[0]
    pid = partition_ids(keys, seed, num_partitions)
    histogram = jnp.zeros((num_partitions,), jnp.int32).at[pid].add(1)
    padded_sizes = (
        (histogram + (block_rows - 1)) // block_rows * block_rows
    ).astype(jnp.int32)
    padded_offsets = jnp.cumsum(padded_sizes) - padded_sizes
    total = n + num_partitions * block_rows  # static capacity bound

    # rank within partition via the same stable sort
    row_ids = jnp.arange(n, dtype=jnp.int32)
    pid_s, keys_s, pay_s, rows_s = jax.lax.sort(
        (pid, keys, payloads, row_ids), num_keys=1, is_stable=True
    )
    dense_offsets = jnp.cumsum(histogram) - histogram
    rank = jnp.arange(n, dtype=jnp.int32) - dense_offsets[pid_s]
    dst = padded_offsets[pid_s] + rank
    keys_out = jnp.zeros((total,), keys.dtype).at[dst].set(keys_s, mode="drop")
    pay_out = jnp.zeros((total,), payloads.dtype).at[dst].set(pay_s, mode="drop")
    rows_out = (
        jnp.full((total,), -1, jnp.int32).at[dst].set(rows_s, mode="drop")
    )
    return PartitionedRelation(
        keys=keys_out,
        payloads=pay_out,
        row_ids=rows_out,
        histogram=histogram,
        offsets=padded_offsets,
    )

"""Sort operators: key sort and multi-pass LSD radix sort.

Part of the extended db_exec_kernel suite (BASELINE.json north star); the
reference has no sort operator — its radix *partitioning* single-pass fan-out
(src/RadixCluster/HashJoin.hpp:333-440) is the first pass of exactly this
algorithm, and ``radix_sort_table`` generalizes it to a full ordering.

Two entry points:

- ``sort_table``: one-shot key sort via ``jax.lax.sort`` — XLA's native sort
  (a one-key sort goes to the GPU's radix sort); the production default.
- ``radix_sort_table``: LSD radix sort, ``32 / bits_per_pass`` stable passes
  over digit histograms.  Each pass is the partition pipeline (digit extract →
  stable reorder); digit reordering currently rides the same XLA stable sort
  primitive (8-bit comparator).  Signed keys are handled by biasing the top digit
  (two's-complement order == unsigned order of ``key ^ 0x80000000``).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from partitionedhashjoin_tpu.data.table import Table, make_table

_SIGN_FLIP = jnp.uint32(0x80000000)


@jax.jit
def sort_by_key(keys: jax.Array, *payloads: jax.Array):
    """Ascending stable sort of ``keys``, reordering ``payloads`` alongside."""
    out = jax.lax.sort((keys,) + payloads, num_keys=1, is_stable=True)
    return out if payloads else out[0]


def sort_table(table: Table) -> Table:
    """Sort a relation by key (ascending, stable)."""
    keys, payloads = sort_by_key(table.keys, table.payloads)
    return make_table(keys, payloads)


@functools.partial(jax.jit, static_argnames=("bits_per_pass",))
def radix_sort(keys: jax.Array, *payloads: jax.Array, bits_per_pass: int = 8):
    """LSD radix sort of int32 keys; returns (sorted_keys, *payloads).

    Invariant per pass p: rows are stably ordered by the low ``p *
    bits_per_pass`` bits — the loop carries full rows, so every pass is a
    gather-free stable reorder of the whole relation.
    """
    if 32 % bits_per_pass:
        raise ValueError(f"bits_per_pass must divide 32, got {bits_per_pass}")
    num_passes = 32 // bits_per_pass
    mask = jnp.uint32((1 << bits_per_pass) - 1)
    # unsigned bias: two's-complement ascending == unsigned ascending of ^MSB
    biased = jnp.asarray(keys).astype(jnp.uint32) ^ _SIGN_FLIP
    carried = (biased,) + payloads
    for p in range(num_passes):
        digit = ((carried[0] >> jnp.uint32(p * bits_per_pass)) & mask).astype(
            jnp.int32
        )
        out = jax.lax.sort((digit,) + carried, num_keys=1, is_stable=True)
        carried = out[1:]
    sorted_keys = (carried[0] ^ _SIGN_FLIP).astype(jnp.int32)
    return (sorted_keys,) + tuple(carried[1:])


def radix_sort_table(table: Table, bits_per_pass: int = 8) -> Table:
    """Radix-sort a relation by key."""
    keys, payloads = radix_sort(
        table.keys, table.payloads, bits_per_pass=bits_per_pass
    )
    return make_table(keys, payloads)

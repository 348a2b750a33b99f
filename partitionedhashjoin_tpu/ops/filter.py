"""Filter + compaction operator.

Part of the extended db_exec_kernel suite (BASELINE.json north star); the
reference has no standalone filter operator — its closest analogue is the
accept/reject masking inside the Zipf sampler (src/DataGenerator/Zipf.cpp:
46-53).  Selection is mask → exclusive prefix sum → scatter (conflict-free by
construction, like the radix scatter, src/RadixCluster/HashJoin.hpp:394-412):
output position of row i is the count of selected rows before i.  Output
capacity is static (default: the input size); ``count`` gives the number of
selected rows.
"""

from __future__ import annotations

import functools
from typing import Callable, Tuple

import jax
import jax.numpy as jnp

from partitionedhashjoin_tpu.data.table import Table, make_table


@functools.partial(jax.jit, static_argnames=("capacity",))
def compact(mask: jax.Array, *columns: jax.Array, capacity=None):
    """Scatter rows where ``mask`` into the front of static-size outputs.

    Returns ``(count, *compacted_columns)``; rows past ``count`` are zeros.
    Stable: selected rows keep their relative order.  ``capacity`` (default
    the input size) bounds the outputs: selected rows past it are dropped,
    and ``count`` stays exact.
    """
    n = mask.shape[0]
    cap = n if capacity is None else capacity
    mask = jnp.asarray(mask, jnp.bool_)
    inc = mask.astype(jnp.int32)
    pos = jnp.cumsum(inc) - inc  # exclusive prefix sum
    dst = jnp.where(mask, pos, cap)  # rejected rows -> dropped slot
    outs = tuple(
        jnp.zeros((cap,), c.dtype).at[dst].set(c, mode="drop")
        for c in columns
    )
    return (jnp.sum(inc),) + outs


@jax.jit
def compact_sort(mask: jax.Array, *columns: jax.Array):
    """Stable partition via one unstable 2-key sort: selected rows first.

    Returns ``(count, *partitioned_columns)``.  Rows past ``count`` are the
    REJECTED rows (also in original order) rather than zeros — a stable
    partition, not a zero-padded compaction.
    """
    n = mask.shape[0]
    flag = jnp.where(jnp.asarray(mask, jnp.bool_), 0, 1).astype(jnp.int32)
    iota = jnp.arange(n, dtype=jnp.int32)
    sorted_ops = jax.lax.sort(
        (flag, iota) + columns, num_keys=2, is_stable=False
    )
    return (n - jnp.sum(sorted_ops[0]),) + tuple(sorted_ops[2:])


def filter_table(
    table: Table,
    predicate: Callable[[jax.Array, jax.Array], jax.Array],
    zero_tail: bool = True,
) -> Tuple[Table, jax.Array]:
    """Select rows where ``predicate(keys, payloads)`` holds.

    Returns ``(compacted_table, count)``; the table keeps the input's static
    size with the selected rows in ``[0, count)`` (original order).  By
    default rows past ``count`` are ZEROS (``compact`` semantics — safe for
    callers that reduce over the full static-capacity column without slicing
    by ``count``).  Pass ``zero_tail=False`` for the sort formulation
    (``compact_sort`` stable partition): rows past ``count`` are then the
    REJECTED rows in original order, NOT zeros.
    """
    mask = predicate(table.keys, table.payloads)
    op = compact if zero_tail else compact_sort
    count, keys, payloads = op(mask, table.keys, table.payloads)
    return make_table(keys, payloads), count

"""ORDER BY / LIMIT operators over Tables.

Extended relational surface (the reference has no ordering operator — its
closest analogue is the sorted output layout of the radix fan-out,
src/RadixCluster/HashJoin.hpp:394-412, which is a partition artifact, not
an operator).  Design notes:

- full ORDER BY is one unstable value-carrying ``lax.sort``;
  descending order rides the same ascending sort through bitwise NOT
  (``~x`` is an order-REVERSING bijection on two's-complement ints, total
  on the full domain including INT_MIN, where ``-x`` would overflow);
- ORDER BY ... LIMIT k avoids the relation sort entirely for small k:
  ``lax.top_k`` + one k-sized payload gather (k-sized gathers are cheap;
  it is RELATION-sized gathers the engine bans).

Determinism: ties are broken by ascending row position in ``order_by``
(position rides as the second sort key), and by ``lax.top_k``'s
lowest-index rule in ``top_k`` — both deterministic, documented orders.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from partitionedhashjoin_tpu.data.table import Table, make_table


def _order_key(col: jax.Array, descending: bool) -> jax.Array:
    if not jnp.issubdtype(col.dtype, jnp.integer):
        raise TypeError(f"order_by supports integer columns, got {col.dtype}")
    return ~col if descending else col


@functools.partial(jax.jit, static_argnames=("by", "descending"))
def _order_by(keys, payloads, by: str, descending: bool):
    col = keys if by == "key" else payloads
    other = payloads if by == "key" else keys
    n = keys.shape[0]
    iota = jnp.arange(n, dtype=jnp.int32)
    _, _, col_s, other_s = jax.lax.sort(
        (_order_key(col, descending), iota, col, other),
        num_keys=2, is_stable=False,
    )
    return col_s, other_s


def order_by(table: Table, by: str = "key", descending: bool = False) -> Table:
    """Return ``table`` sorted by ``by`` ("key" or "payload").

    One unstable 2-key value-carrying sort (position tiebreak keeps the
    output deterministic and row-stable among equal sort values).
    """
    if by not in ("key", "payload"):
        raise ValueError(f"by must be 'key' or 'payload', got {by!r}")
    col_s, other_s = _order_by(table.keys, table.payloads, by, descending)
    if by == "key":
        return make_table(col_s, other_s)
    return make_table(other_s, col_s)


@functools.partial(jax.jit, static_argnames=("k", "by", "descending"))
def _top_k(keys, payloads, k: int, by: str, descending: bool):
    col = keys if by == "key" else payloads
    other = payloads if by == "key" else keys
    # top_k returns the k LARGEST of its argument; ascending order wants
    # the k smallest, i.e. the largest of ~col, un-negated afterwards
    vals, idx = jax.lax.top_k(_order_key(col, not descending), k)
    col_k = ~vals if not descending else vals
    return col_k, other[idx]


def top_k(
    table: Table, k: int, by: str = "key", descending: bool = True
) -> Table:
    """ORDER BY ... LIMIT k without the relation sort.

    Returns a k-row Table of the largest (``descending=True``, default) or
    smallest rows by the chosen column, in sorted order.  ``k`` must not
    exceed the table size (static shapes).  Cost: one streaming
    ``lax.top_k`` pass + one k-sized gather for the carried column — no
    relation-sized reorder, so this is the idiom for small-k LIMITs; for
    k approaching the relation size use ``order_by`` and slice.
    """
    if by not in ("key", "payload"):
        raise ValueError(f"by must be 'key' or 'payload', got {by!r}")
    if k <= 0:
        raise ValueError(f"k must be positive, got {k}")
    if k > table.size:
        raise ValueError(f"k={k} exceeds table size {table.size}")
    col_k, other_k = _top_k(table.keys, table.payloads, k, by, descending)
    if by == "key":
        return make_table(col_k, other_k)
    return make_table(other_k, col_k)

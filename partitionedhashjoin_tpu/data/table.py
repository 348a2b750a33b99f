"""Struct-of-arrays relation table.

Counterpart of the reference's row-oriented
``Table<Tuple{int64 id, int64 payload}>`` (src/Common/Table.hpp:20-57).  A
row-array of 16-byte aligned tuples is the right layout for cache-line
pointer-chasing on a CPU; on an accelerator the right layout is
struct-of-arrays so keys and payloads stream as dense coalesced vectors.
Identity is a UUID like the reference (src/Common/Table.cpp:18-22).

The table is a registered pytree, so it passes through jit/shard_map freely;
``uuid`` is static metadata.
"""

from __future__ import annotations

import dataclasses
import uuid as _uuid

import jax
import jax.numpy as jnp


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Table:
    """A relation: parallel ``keys`` and ``payloads`` vectors.

    ``keys[i]`` mirrors Tuple::id and ``payloads[i]`` mirrors Tuple::payload
    (Table.hpp:20-25).  Both default to int32 (the reference uses int64; the
    benchmark domain fits 32 bits — int64 is supported via jax x64 mode).
    """

    keys: jax.Array
    payloads: jax.Array
    uuid: str = dataclasses.field(
        default="", metadata=dict(static=True)
    )

    def __post_init__(self) -> None:
        if not self.uuid:
            object.__setattr__(self, "uuid", str(_uuid.uuid4()))

    @property
    def size(self) -> int:
        return self.keys.shape[0]

    def get_size(self) -> int:
        """Parity alias for Table::GetSize (Table.hpp:47)."""
        return self.size

    def get_id(self) -> str:
        """Parity alias for Table::GetID (Table.hpp:49)."""
        return self.uuid

    def block_until_ready(self) -> "Table":
        jax.block_until_ready((self.keys, self.payloads))
        return self


@dataclasses.dataclass
class JoinedTable:
    """Join output: (key, payloadA, payloadB) columns + a valid-row count.

    Counterpart of Table<JoinedTuple> (src/Common/Table.hpp:27-33).  Join
    output sizes are data-dependent, so the arrays are sized to a static
    capacity and ``count`` gives the number of valid rows.  The reference
    never materializes join output either — it returns an empty table and
    logs only the match count (src/NoPartitioning/HashJoin.hpp:184-186).
    """

    keys: jax.Array
    payloads_a: jax.Array
    payloads_b: jax.Array
    count: jax.Array  # scalar int64-ish count of valid rows
    #: per-row NULL indicator (left joins: True iff ``payloads_a[i]`` is a
    #: real build payload rather than the NULL-filled zero; a matched row
    #: whose build payload is legitimately 0 is distinguishable only through
    #: this column).  None on paths that only emit matching rows.
    matched: "jax.Array | None" = None


def make_table(keys, payloads, uuid: str = "") -> Table:
    keys = jnp.asarray(keys)
    payloads = jnp.asarray(payloads)
    if keys.shape != payloads.shape:
        raise ValueError(
            f"Table columns must align: keys {keys.shape} vs payloads {payloads.shape}"
        )
    return Table(keys=keys, payloads=payloads, uuid=uuid)

"""Vectorized open-addressing hash table (build + probe kernels).

Counterpart of the reference's latched linear-probing hash table
(src/HashTables/LinearProbing.hpp:90-210).  The reference resolves concurrent
inserts with per-bucket ``std::atomic_flag`` spinlocks (LinearProbing.hpp:
120-126) and probes by pointer-chasing bucket chains.  This implementation
uses no atomics and no locks — it makes every phase conflict-free *by
construction* (the same property the reference's scatter phase has,
src/RadixCluster/HashJoin.hpp:394-412):

- **Build** is an iterative claim/resolve loop: every pending row computes its
  candidate slot ``(h + d) & mask``; rows pointing at occupied slots advance
  their probe distance; rows pointing at empty slots *claim* them with a
  deterministic ``scatter-min`` of their row id (XLA scatter-min is
  associative ⇒ one winner per slot, no races); winners write their entry,
  losers retry.  Expected O(max probe chain) rounds at load factor <= 0.5.
- **Probe** is a lockstep gather loop with per-row active masks, terminating
  at a key match (`Get`, LinearProbing.hpp:159-180), at an empty slot, or at
  the recorded maximum probe distance.  The classic linear-probing invariant
  (a key inserted at distance d saw slots h..h+d-1 occupied, and entries are
  never removed) makes empty-slot termination exact.

Slot occupancy is tracked in the value lane (build-row indices are >= 0, empty
slots hold -1) so keys may take any int32 value — no key sentinel is reserved,
unlike typical open-addressing designs.

Duplicate keys occupy distinct slots along the probe chain, preserving the
reference's multiset semantics (``GetAll``, LinearProbing.hpp:182-200):
``probe_count_all`` counts every duplicate, ``probe_exists``/``probe_get``
stop at the first (insertion-order nondeterministic, as in the concurrent
reference build).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from partitionedhashjoin_tpu.ops import hashing

#: Default slots-per-key ratio.  The reference uses 1.25 buckets-per-key with
#: 3-slot buckets (load factor ~0.27, LinearProbing.hpp:16-18, main.cpp:211).
#: We use individual slots at a power-of-two count >= 2x keys (load <= 0.5),
#: which keeps expected probe chains ~1.5 and the vectorized build loop short.
DEFAULT_SIZE_RATIO = 2.0

_INT32_MAX = jnp.iinfo(jnp.int32).max



def _as_i32_keys(keys):
    """Coerce to int32, refusing 64-bit inputs (silent truncation would make
    distinct keys collide).  64-bit keys take the sort-merge path
    (ops/sort_merge.py, dtype-generic) or hashing.hash64_pair."""
    keys = jnp.asarray(keys)
    if keys.dtype in (jnp.int64, jnp.uint64):
        raise TypeError(
            "hash-table kernels are 32-bit; use sort_merge for int64 keys"
        )
    return keys.astype(jnp.int32)


def dispatch_chunks(n: int, target: int = 25_000_000) -> int:
    """Number of chunks keeping each probe chunk <= ~``target`` rows.

    Chunking happens at the DISPATCH level (separate jit calls), so one
    program's runtime and temporaries stay bounded (whether the H100 needs
    the split is an open question in ROADMAP.md).  Divisibility is NOT
    required: chunked probes slice ``ceil(n / chunks)``-row windows and the
    last window overlaps the previous one, masking the overlap via a traced
    ``skip`` scalar — so a prime-sized relation still chunks (round-1 ADVICE:
    the old largest-divisor rule collapsed prime-ish n to a single
    relation-sized dispatch).
    """
    return max(1, -(-n // target))


def table_size_for(n: int, ratio: float = DEFAULT_SIZE_RATIO) -> int:
    """Power-of-two slot count >= ratio * n (cf. getNumberOfBuckets,
    src/HashTables/LinearProbing.cpp:7-12 — ceil(ratio*n), made pow2 here so
    the mask reduction stays a single AND on the VPU)."""
    if n <= 0:
        return 1
    want = max(1, int(-(-n * ratio // 1)))
    size = 1
    while size < want:
        size <<= 1
    return size


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class HashTable:
    """A built table: parallel slot arrays + probe-depth bound.

    ``slot_keys[s]`` is meaningful iff ``slot_rows[s] >= 0``; ``slot_rows``
    holds the build-relation row index (the reference stores tuple pointers,
    LinearProbing.hpp:113-134 — a row index is the SoA equivalent).
    ``max_probe`` is the largest insertion probe distance, bounding every
    probe loop.  ``overflowed`` is True iff the build loop hit its iteration
    bound with rows still pending — only possible when ``has_valid=True``
    hides a valid-row count larger than ``size`` (the unmasked path raises
    host-side); probing an overflowed table undercounts, so callers sizing
    tables from dynamic valid counts must check it.
    """

    slot_keys: jax.Array  # int32[size]
    slot_rows: jax.Array  # int32[size], -1 == empty
    max_probe: jax.Array  # int32 scalar
    seed: jax.Array  # uint32 scalar hash seed
    overflowed: jax.Array = dataclasses.field(
        default_factory=lambda: jnp.asarray(False)
    )

    @property
    def size(self) -> int:
        return self.slot_keys.shape[0]


def _bucket_of(keys, seed, mask):
    h = hashing.hash32(keys, seed)
    return (h & jnp.uint32(mask)).astype(jnp.int32)


@functools.partial(
    jax.jit, static_argnums=(2,), static_argnames=("size", "has_valid")
)
def build_hash_table(
    keys: jax.Array,
    seed: jax.Array,
    size: int,
    valid: "jax.Array | None" = None,
    has_valid: bool = False,
) -> HashTable:
    """Insert all ``keys`` into a fresh table of ``size`` slots (power of 2).

    Vectorized replacement for the reference's parallel latched insert loop
    (src/NoPartitioning/HashJoin.hpp:93-115 driving LinearProbing.hpp:113-134).
    ``seed`` is a traced uint32 scalar, mirroring the per-instance random
    hasher seed (src/Common/XXHasher.hpp:12-17) without recompilation.
    Rows with ``valid == False`` (padding from bucketized exchanges) are
    skipped; pass ``has_valid=True`` alongside.
    """
    n = keys.shape[0]
    if size & (size - 1):
        raise ValueError(f"table size must be a power of two, got {size}")
    if size < n and not has_valid:
        raise ValueError(f"table size {size} < number of keys {n}")
    mask = size - 1
    keys = _as_i32_keys(keys)
    seed = jnp.asarray(seed).astype(jnp.uint32)
    home = _bucket_of(keys, seed, mask)
    row_ids = jnp.arange(n, dtype=jnp.int32)
    initial_pending = (
        jnp.asarray(valid, jnp.bool_)
        if has_valid
        else jnp.ones((n,), jnp.bool_)
    )

    def body(state):
        slot_keys, slot_rows, dist, pending, max_probe, it = state
        slot = (home + dist) & mask
        occupied = slot_rows[slot] >= 0
        # Rows staring at a full slot move one step down their chain
        # (LinearProbing.hpp:132 wraparound equivalent via the mask).
        advance = pending & occupied
        dist = jnp.where(advance, dist + 1, dist)
        # Rows staring at an empty slot race for it; scatter-min of the row id
        # deterministically picks one winner per slot.
        trying = pending & ~occupied
        claim_slot = jnp.where(trying, slot, size)  # losers -> dump slot
        claims = (
            jnp.full((size + 1,), _INT32_MAX, jnp.int32)
            .at[claim_slot]
            .min(row_ids)
        )
        won = trying & (claims[slot] == row_ids)
        write_slot = jnp.where(won, slot, size)
        slot_keys = slot_keys.at[write_slot].set(keys, mode="drop")
        slot_rows = slot_rows.at[write_slot].set(row_ids, mode="drop")
        pending = pending & ~won
        max_probe = jnp.maximum(
            max_probe, jnp.max(jnp.where(won, dist, 0), initial=0)
        )
        return slot_keys, slot_rows, dist, pending, max_probe, it + 1

    def cond(state):
        # Each iteration either inserts >= 1 row (<= n wins total) or every
        # pending row advances one chain step (dist <= size once the table is
        # full of OTHER keys); n + size + 2 therefore bounds any feasible
        # build, and hitting it means the valid-row count exceeds the slot
        # count — a silent device hang before this bound existed (round-1
        # ADVICE) — now surfaced as ``overflowed``.
        return jnp.any(state[3]) & (state[5] < n + size + 2)

    init = (
        jnp.zeros((size,), jnp.int32),
        jnp.full((size,), -1, jnp.int32),
        jnp.zeros((n,), jnp.int32),
        initial_pending,
        jnp.asarray(0, jnp.int32),
        jnp.asarray(0, jnp.int32),
    )
    slot_keys, slot_rows, _, pending, max_probe, _ = jax.lax.while_loop(
        cond, body, init
    )
    return HashTable(
        slot_keys=slot_keys,
        slot_rows=slot_rows,
        max_probe=max_probe,
        seed=seed,
        overflowed=jnp.any(pending),
    )


def _probe_loop(
    table: HashTable, keys: jax.Array, count_all: bool, valid=None
):
    """Shared lockstep probe: returns (found, first_row, match_count).

    ``valid=False`` rows (exchange padding) never probe and never match.
    """
    n = keys.shape[0]
    mask = table.size - 1
    keys = _as_i32_keys(keys)
    home = _bucket_of(keys, table.seed, mask)
    initial_active = (
        jnp.asarray(valid, jnp.bool_)
        if valid is not None
        else jnp.ones((n,), jnp.bool_)
    )

    def body(state):
        dist, active, found, first_row, matches = state
        slot = (home + dist) & mask
        rows = table.slot_rows[slot]
        slot_keys = table.slot_keys[slot]
        occupied = rows >= 0
        hit = active & occupied & (slot_keys == keys)
        empty = active & ~occupied
        first_row = jnp.where(hit & ~found, rows, first_row)
        found = found | hit
        matches = matches + hit.astype(jnp.int32)
        if count_all:
            # GetAll semantics (LinearProbing.hpp:182-200): keep scanning the
            # chain past hits, stop only at an empty slot / depth bound.
            active = active & ~empty
        else:
            active = active & ~hit & ~empty
        active = active & (dist < table.max_probe)
        return dist + 1, active, found, first_row, matches

    def cond(state):
        return jnp.any(state[1])

    init = (
        jnp.zeros((n,), jnp.int32),
        initial_active,
        jnp.zeros((n,), jnp.bool_),
        jnp.full((n,), -1, jnp.int32),
        jnp.zeros((n,), jnp.int32),
    )
    _, _, found, first_row, matches = jax.lax.while_loop(cond, body, init)
    return found, first_row, matches


@jax.jit
def probe_exists(
    table: HashTable, keys: jax.Array, valid=None
) -> jax.Array:
    """bool[n]: key present?  (``Exists``, LinearProbing.hpp:136-157)."""
    found, _, _ = _probe_loop(table, keys, count_all=False, valid=valid)
    return found


@jax.jit
def probe_get(table: HashTable, keys: jax.Array):
    """(found bool[n], build_row int32[n]) — first match per probe key
    (``Get``, LinearProbing.hpp:159-180; -1 where absent)."""
    found, first_row, _ = _probe_loop(table, keys, count_all=False)
    return found, first_row


@jax.jit
def probe_count_all(table: HashTable, keys: jax.Array) -> jax.Array:
    """int32[n]: number of matching build entries per probe key
    (``GetAll`` cardinality, LinearProbing.hpp:182-200)."""
    _, _, matches = _probe_loop(table, keys, count_all=True)
    return matches


# ---------------------------------------------------------------------------
# Chained bucket table: the fast hash-join table.
#
# The claim/resolve open-addressing build costs O(max probe chain) full
# scatter/gather passes; a bucket-chained layout
# needs ONE stable sort: rows sorted by bucket ARE the chains, and
# ``offsets`` delimit them (the same insight as ops/radix.py's sort-based
# scatter).  This is the SeparateChaining analogue
# (src/HashTables/SeparateChaining.hpp:143-277) with chains stored
# contiguously instead of via next-pointers — a 4-entry window of a
# contiguous chain costs one memory transaction, the same as a single
# pointer hop.
#
# Probe: bucket b holds rows [offsets[b], offsets[b+1]); a gather of a
# WINDOW-wide slice resolves chains up to WINDOW long in one pass; rarer
# longer chains take further window passes (load factor 1 ⇒ Poisson chains:
# P(len>4) < 0.4%).
# ---------------------------------------------------------------------------

PROBE_WINDOW = 4


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ChainedHashTable:
    """Bucket-chained table: sorted entry arrays + bucket offsets."""

    entry_keys: jax.Array  # int32[n]  keys grouped by bucket
    entry_rows: jax.Array  # int32[n]  original build-row index per entry
    offsets: jax.Array  # int32[num_buckets + 1]  chain boundaries
    max_chain: jax.Array  # int32 scalar: longest chain
    seed: jax.Array  # uint32 scalar hash seed

    @property
    def num_buckets(self) -> int:
        return self.offsets.shape[0] - 1


def chained_num_buckets(n: int) -> int:
    """Pow2 bucket count >= n (load factor <= 1)."""
    size = 1
    while size < max(1, n):
        size <<= 1
    return size


@functools.partial(jax.jit, static_argnames=("num_buckets",))
def build_chained_from_buckets(
    bucket: jax.Array, keys: jax.Array, seed: jax.Array, num_buckets: int
) -> ChainedHashTable:
    """Chained build from precomputed bucket ids (one stable sort).

    Callers with structured bucket maps (the radix join's partition-segmented
    buckets, ops/radix_cluster.py) compute ``bucket`` themselves; plain
    tables use ``build_chained``.
    """
    n = keys.shape[0]
    keys = _as_i32_keys(keys)
    seed = jnp.asarray(seed).astype(jnp.uint32)
    rows = jnp.arange(n, dtype=jnp.int32)
    _, entry_keys, entry_rows = jax.lax.sort(
        (bucket, keys, rows), num_keys=1, is_stable=True
    )
    counts = jnp.zeros((num_buckets,), jnp.int32).at[bucket].add(
        1, mode="drop"
    )
    offsets = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(counts)]
    )
    return ChainedHashTable(
        entry_keys=entry_keys,
        entry_rows=entry_rows,
        offsets=offsets,
        max_chain=jnp.max(counts, initial=0),
        seed=seed,
    )


@functools.partial(jax.jit, static_argnames=("num_buckets",))
def build_chained(
    keys: jax.Array, seed: jax.Array, num_buckets: int
) -> ChainedHashTable:
    """One-sort bucket-chained build (vs the reference's latched inserts)."""
    keys = _as_i32_keys(keys)
    seed_u = jnp.asarray(seed).astype(jnp.uint32)
    bucket = _bucket_of(keys, seed_u, num_buckets - 1)
    return build_chained_from_buckets(bucket, keys, seed_u, num_buckets)


def _probe_chained_block(
    table: ChainedHashTable, keys: jax.Array, bucket=None, need_rows=True
):
    """(found, first_row) for one probe block via windowed chain scans.

    ``bucket`` overrides the default hash-derived bucket (used by the radix
    join's partition-segmented bucket map).  ``need_rows=False`` (the count
    path) skips the entry-row gathers — nearly half the probe's memory
    traffic."""
    n = keys.shape[0]
    nbkt = table.num_buckets
    keys = _as_i32_keys(keys)
    if bucket is None:
        bucket = _bucket_of(keys, table.seed, nbkt - 1)
    start = table.offsets[bucket]
    end = table.offsets[bucket + 1]

    def window_pass(state):
        pos, active, found, first_row = state
        idx = pos[:, None] + jnp.arange(PROBE_WINDOW, dtype=jnp.int32)[None, :]
        in_chain = idx < end[:, None]
        idx_c = jnp.minimum(idx, table.entry_keys.shape[0] - 1)
        wkeys = table.entry_keys[idx_c]  # contiguous (n, WINDOW) gather
        match = in_chain & (wkeys == keys[:, None]) & active[:, None]
        any_match = jnp.any(match, axis=1)
        if need_rows:
            wrows = table.entry_rows[idx_c]
            first_in_window = jnp.argmax(match, axis=1)
            row = wrows[jnp.arange(n), first_in_window]
            first_row = jnp.where(any_match & ~found, row, first_row)
        found = found | any_match
        pos = pos + PROBE_WINDOW
        active = active & ~any_match & (pos < end)
        return pos, active, found, first_row

    init = (
        start,
        (start < end),
        jnp.zeros((n,), jnp.bool_),
        jnp.full((n,), -1, jnp.int32),
    )
    _, _, found, first_row = jax.lax.while_loop(
        lambda s: jnp.any(s[1]), window_pass, init
    )
    return found, first_row


@jax.jit
def _probe_chained_count_chunk(
    table: ChainedHashTable, keys: jax.Array, bucket=None, skip=None
) -> jax.Array:
    """Count-only probe, tail-compacted.

    ``skip`` (traced int32 scalar) excludes rows with index < skip from the
    count — the overlapping-window chunking trick: the LAST chunk of a
    non-divisible probe is the final ``m`` rows, and ``skip`` masks the rows
    the previous chunk already counted.  One compiled program serves every
    chunk (a static remainder shape would cost a second compile).

    The lockstep window loop costs FULL-array gathers per pass, and pass
    count is driven by the MAX chain (~3 passes at load 1.0) even though
    almost every row resolves in pass one.  So: one unrolled first-window
    pass over all rows, then COMPACT the few still-active rows (longer
    chains, no match yet) into an n/8 buffer and loop only on that.  If the
    tail overflows (adversarial duplication), a lax.cond falls back to the
    full lockstep loop — counts stay exact in every case.
    """
    n = keys.shape[0]
    nbkt = table.num_buckets
    keys = _as_i32_keys(keys)
    if bucket is None:
        bucket = _bucket_of(keys, table.seed, nbkt - 1)
    start = table.offsets[bucket]
    end = table.offsets[bucket + 1]
    cap = table.entry_keys.shape[0] - 1
    counted = (
        jnp.ones((n,), jnp.bool_)
        if skip is None
        else jnp.arange(n, dtype=jnp.int32) >= skip
    )

    # pass 1: first window, all rows
    idx = start[:, None] + jnp.arange(PROBE_WINDOW, dtype=jnp.int32)[None, :]
    in_chain = idx < end[:, None]
    wkeys = table.entry_keys[jnp.minimum(idx, cap)]
    found1 = jnp.any(in_chain & (wkeys == keys[:, None]), axis=1) & counted
    count1 = jnp.sum(found1.astype(jnp.int32))
    pos2 = start + PROBE_WINDOW
    active = (~found1) & counted & (pos2 < end)
    n_active = jnp.sum(active.astype(jnp.int32))

    tail_cap = max(128, n // 8)
    dst = jnp.where(
        active, jnp.cumsum(active.astype(jnp.int32)) - 1, tail_cap
    )
    t_keys = jnp.zeros((tail_cap,), jnp.int32).at[dst].set(keys, mode="drop")
    t_pos = jnp.zeros((tail_cap,), jnp.int32).at[dst].set(pos2, mode="drop")
    t_end = jnp.zeros((tail_cap,), jnp.int32).at[dst].set(end, mode="drop")

    def tail_count(_):
        def window_pass(state):
            pos, act, cnt = state
            tidx = pos[:, None] + jnp.arange(
                PROBE_WINDOW, dtype=jnp.int32
            )[None, :]
            t_in = tidx < t_end[:, None]
            tk = table.entry_keys[jnp.minimum(tidx, cap)]
            m = jnp.any(t_in & (tk == t_keys[:, None]) & act[:, None], axis=1)
            cnt = cnt + jnp.sum(m.astype(jnp.int32))
            pos = pos + PROBE_WINDOW
            act = act & ~m & (pos < t_end)
            return pos, act, cnt

        valid = jnp.arange(tail_cap, dtype=jnp.int32) < n_active
        _, _, cnt = jax.lax.while_loop(
            lambda s: jnp.any(s[1]),
            window_pass,
            (t_pos, valid & (t_pos < t_end), jnp.asarray(0, jnp.int32)),
        )
        return count1 + cnt

    def full_fallback(_):
        found, _ = _probe_chained_block(
            table, keys, bucket=bucket, need_rows=False
        )
        return jnp.sum((found & counted).astype(jnp.int32))

    return jax.lax.cond(
        n_active <= tail_cap, tail_count, full_fallback, operand=None
    )


def probe_chained_count(
    table: ChainedHashTable, keys: jax.Array, num_chunks: int = 1
) -> jax.Array:
    """Get-semantics match count; ``num_chunks`` splits the probe into
    separate dispatches, bounding both the (n, WINDOW) gather temporaries
    and single-program runtime.

    Non-divisible ``n`` is handled with overlapping windows: every chunk is
    ``ceil(n / num_chunks)`` rows; the last one starts at ``n - m`` and a
    traced ``skip`` masks the rows the previous chunk already counted, so
    every chunk shares one compiled program.
    """
    n = keys.shape[0]
    keys = _as_i32_keys(keys)
    num_chunks = min(num_chunks, max(1, n))
    if num_chunks <= 1:
        return _probe_chained_count_chunk(table, keys)
    m = -(-n // num_chunks)
    total = None
    for c in range(num_chunks):
        start = min(c * m, n - m)
        skip = c * m - start  # rows [0, skip) were counted by chunk c-1
        cnt = _probe_chained_count_chunk(
            table,
            jax.lax.dynamic_slice(keys, (start,), (m,)),
            skip=jnp.asarray(skip, jnp.int32),
        )
        total = cnt if total is None else total + cnt
    return total


@jax.jit
def probe_chained_get(table: ChainedHashTable, keys: jax.Array):
    """(found, build_row) — first match per probe key (Get semantics)."""
    return _probe_chained_block(table, keys)


@jax.jit
def probe_chained_count_all(
    table: ChainedHashTable, keys: jax.Array
) -> jax.Array:
    """int32[n]: build multiplicity per probe key (``GetAll`` cardinality,
    SeparateChaining.hpp:256-265 semantics) — windows scan each bucket chain
    to its end, accumulating matches."""
    n = keys.shape[0]
    keys = _as_i32_keys(keys)
    bucket = _bucket_of(keys, table.seed, table.num_buckets - 1)
    start = table.offsets[bucket]
    end = table.offsets[bucket + 1]

    def window_pass(state):
        pos, active, matches = state
        idx = pos[:, None] + jnp.arange(PROBE_WINDOW, dtype=jnp.int32)[None, :]
        in_chain = idx < end[:, None]
        idx_c = jnp.minimum(idx, table.entry_keys.shape[0] - 1)
        wkeys = table.entry_keys[idx_c]
        match = in_chain & (wkeys == keys[:, None]) & active[:, None]
        matches = matches + jnp.sum(match.astype(jnp.int32), axis=1)
        pos = pos + PROBE_WINDOW
        active = active & (pos < end)
        return pos, active, matches

    init = (start, (start < end), jnp.zeros((n,), jnp.int32))
    _, _, matches = jax.lax.while_loop(
        lambda s: jnp.any(s[1]), window_pass, init
    )
    return matches


@functools.partial(
    jax.jit, static_argnums=(2,), static_argnames=("size", "has_valid")
)
def build_dedup_hash_table(
    keys: jax.Array,
    seed: jax.Array,
    size: int,
    valid: "jax.Array | None" = None,
    has_valid: bool = False,
):
    """Insert each *distinct* key once; map every row to its representative.

    Returns ``(table, rep_row)`` where ``rep_row[i]`` is the build-row index
    of the slot that owns row i's key (identical for all duplicates of a
    key).  The claim loop is the ``build_hash_table`` loop plus one rule: a
    pending row that sees its own key already in a slot resolves to that
    slot's owner instead of probing on.  Probe-chain length therefore depends
    only on *distinct*-key collisions — a key duplicated 18M times (Zipf head)
    costs one slot, not an 18M-slot cluster.

    This is the engine's GROUP BY backbone (ops/aggregate.py); the reference
    has no aggregate operator — it is part of the extended db_exec_kernel
    suite (BASELINE.json configs[3]).  Rows with ``valid == False`` are never
    inserted and keep ``rep_row == -1`` (pass ``has_valid=True`` alongside).
    """
    n = keys.shape[0]
    if size & (size - 1):
        raise ValueError(f"table size must be a power of two, got {size}")
    mask = size - 1
    keys = _as_i32_keys(keys)
    seed = jnp.asarray(seed).astype(jnp.uint32)
    home = _bucket_of(keys, seed, mask)
    row_ids = jnp.arange(n, dtype=jnp.int32)

    def body(state):
        slot_keys, slot_rows, dist, pending, rep_row, max_probe, it = state
        slot = (home + dist) & mask
        occ_rows = slot_rows[slot]
        occ_keys = slot_keys[slot]
        occupied = occ_rows >= 0
        same_key = occupied & (occ_keys == keys)
        # duplicate rule: resolve to the slot owner
        dup = pending & same_key
        rep_row = jnp.where(dup, occ_rows, rep_row)
        pending = pending & ~dup
        advance = pending & occupied
        dist = jnp.where(advance, dist + 1, dist)
        trying = pending & ~occupied
        claim_slot = jnp.where(trying, slot, size)
        claims = (
            jnp.full((size + 1,), _INT32_MAX, jnp.int32)
            .at[claim_slot]
            .min(row_ids)
        )
        won = trying & (claims[slot] == row_ids)
        write_slot = jnp.where(won, slot, size)
        slot_keys = slot_keys.at[write_slot].set(keys, mode="drop")
        slot_rows = slot_rows.at[write_slot].set(row_ids, mode="drop")
        rep_row = jnp.where(won, row_ids, rep_row)
        pending = pending & ~won
        max_probe = jnp.maximum(
            max_probe, jnp.max(jnp.where(won, dist, 0), initial=0)
        )
        return slot_keys, slot_rows, dist, pending, rep_row, max_probe, it + 1

    init = (
        jnp.zeros((size,), jnp.int32),
        jnp.full((size,), -1, jnp.int32),
        jnp.zeros((n,), jnp.int32),
        jnp.asarray(valid, jnp.bool_) if has_valid else jnp.ones((n,), jnp.bool_),
        jnp.full((n,), -1, jnp.int32),
        jnp.asarray(0, jnp.int32),
        jnp.asarray(0, jnp.int32),
    )
    # same iteration bound as build_hash_table: the dedup rule only removes
    # pending rows faster (duplicates resolve without inserting)
    slot_keys, slot_rows, _, pending, rep_row, max_probe, _ = jax.lax.while_loop(
        lambda s: jnp.any(s[3]) & (s[6] < n + size + 2), body, init
    )
    table = HashTable(
        slot_keys=slot_keys,
        slot_rows=slot_rows,
        max_probe=max_probe,
        seed=seed,
        overflowed=jnp.any(pending),
    )
    return table, rep_row


# ---------------------------------------------------------------------------
# Segment geometry: P per-partition bucket ranges in one flat space.
#
# The radix join's "factory.New(|A_p|) per partition" loop
# (src/RadixCluster/HashJoin.hpp:278-286) becomes per-partition bucket
# ranges inside one flat chained table (ops/radix_cluster.py).  Capacities
# are data-dependent (Zipf partitions are very uneven) but live inside a
# *static* budget of ``segmented_capacity`` buckets, so shapes stay
# XLA-friendly.
# ---------------------------------------------------------------------------

#: Per-partition capacity rounding granularity (slots).
SEGMENT_GRANULE = 8


def segmented_capacity(
    n: int, num_partitions: int, ratio: float = DEFAULT_SIZE_RATIO
) -> int:
    """Static upper bound on total slots: ratio*n plus one granule per
    partition of round-up slack."""
    return int(n * ratio) + num_partitions * SEGMENT_GRANULE



def segment_geometry(histogram: jax.Array, ratio: float = DEFAULT_SIZE_RATIO):
    """(offsets, caps) for per-partition bucket ranges sized ratio * |A_p|,
    rounded up to SEGMENT_GRANULE (getNumberOfBuckets semantics,
    src/HashTables/LinearProbing.cpp:7-12, per partition).

    Integer arithmetic throughout: float32 ceil is inexact above 2^24 rows
    per partition and could push total capacity past the static budget,
    producing out-of-range bucket ids that silently drop rows.  ``ratio``
    is rationalized (exact for the 1.0 / 1.25 / 2.0 ratios in use).
    """
    from fractions import Fraction

    frac = Fraction(ratio).limit_denominator(64)
    num, den = frac.numerator, frac.denominator
    want = (histogram * num + (den - 1)) // den  # ceil(hist * ratio), exact
    caps = (
        (want + (SEGMENT_GRANULE - 1)) // SEGMENT_GRANULE * SEGMENT_GRANULE
    )
    caps = jnp.maximum(caps, SEGMENT_GRANULE).astype(jnp.int32)
    offsets = jnp.cumsum(caps) - caps
    return offsets, caps



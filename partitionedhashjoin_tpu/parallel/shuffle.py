"""Distributed shuffle hash join over a device mesh, with skew handling.

The reference is single-process: its "shuffle" is the radix scatter into
shared memory (src/RadixCluster/HashJoin.hpp:394-412) and its "workers" are
threads (src/Common/ThreadPool.cpp).  The mesh scale-out counterpart
(SURVEY.md §2 "Distributed communication backend", §7 step 6):

1. **Exchange (partition phase).**  Inside ``shard_map``, every shard assigns
   each local row an owner shard ``hash(key) % S``, bucketizes rows into an
   ``(S, C)`` send tensor (stable sort by destination — the same conflict-free
   rank+scatter as ops/radix.py), and swaps buckets with ``lax.all_to_all``
   (NCCL over NVLink on a GPU host).  Bucket capacity ``C`` is static (XLA
   needs static shapes where the reference used data-dependent
   ``PartitionsInfo`` boundaries): ``C = ceil(local_rows / S * slack)``;
   dropped rows are *counted* and surfaced, and the driver retries with
   doubled slack so results are always exact.
2. **Skew / heavy-hitter handling (the EP analogue).**  Zipf heads break
   hash-sharding — at α=1.25 one key is ~21% of the probe relation, so its
   owner shard would receive ~S× the average bucket.  A sample-based plan
   (``plan_hot_keys``) finds hot keys; build rows with hot keys are
   *replicated* to every shard via ``all_gather`` (they are few — the build
   side is roughly unique), and hot probe rows never travel: each shard
   probes its local hot rows against the replicated hot table.  Cold rows
   take path 1.  Match counts are unchanged by construction: hot and cold
   probe rows are disjoint by key.
3. **Local join + global count.**  Each shard builds a flat hash table over
   its received cold build rows and probes its received cold probe rows
   (ops/hash_table.py kernels, valid-masked for padding); ``psum`` replaces
   the reference's global atomic counter (NoPartitioning/HashJoin.hpp:156).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from partitionedhashjoin_tpu.data.table import Table
from partitionedhashjoin_tpu.ops import hash_table as ht
from partitionedhashjoin_tpu.ops import hashing, merge_join
from partitionedhashjoin_tpu.parallel.mesh import SHARD_AXIS
from partitionedhashjoin_tpu.utils.logger import get_new_logger
from partitionedhashjoin_tpu.utils.results import IHashJoinTimer, NoOpHashJoinTimer

_shard_map = jax.shard_map if hasattr(jax, "shard_map") else None
if _shard_map is None:  # pragma: no cover - jax version fallback
    from jax.experimental.shard_map import shard_map as _shard_map


def _owner_shard(keys, seed, num_shards: int):
    """Owner shard of a key: hash % S (pow2 mask like partition_ids)."""
    if num_shards & (num_shards - 1):
        raise ValueError(f"num_shards must be a power of 2, got {num_shards}")
    h = hashing.hash32(keys, seed)
    return (h & jnp.uint32(num_shards - 1)).astype(jnp.int32)


def _bucketize(dest, valid, capacity: int, num_shards: int, *columns):
    """Pack rows into (num_shards * capacity) send buckets by destination.

    Returns (bucketed_columns..., bucket_valid, dropped_count).  Rows beyond
    a bucket's capacity are dropped and counted (any drop triggers a
    larger-slack retry in the driver, so which rows drop is irrelevant).

    Streaming by design: one UNstable sort by destination (extra operands
    ride as values) makes each destination's rows contiguous, segment
    boundaries come from a binary search of the S destination ids over the
    sorted array (O(S log n) gathers), and the spread into capacity-strided
    buckets is S contiguous ``dynamic_slice``s per column — no per-row
    scatter.
    """
    d = jnp.where(valid, dest, num_shards)  # invalid -> dump segment
    sorted_cols = jax.lax.sort(
        (d,) + tuple(columns), num_keys=1, is_stable=False
    )
    d_s, cols_s = sorted_cols[0], sorted_cols[1:]
    # bounds[s] = first sorted position with destination >= s
    bounds = jnp.searchsorted(
        d_s, jnp.arange(num_shards + 1, dtype=d_s.dtype)
    ).astype(jnp.int32)
    hist = bounds[1:] - bounds[:-1]  # rows per destination (dump excluded)

    def spread(col):
        # pad so a slice starting at bounds[s] <= n never clamps/shifts
        col_pad = jnp.concatenate([col, jnp.zeros((capacity,), col.dtype)])
        return jnp.concatenate(
            [
                jax.lax.dynamic_slice(col_pad, (bounds[s],), (capacity,))
                for s in range(num_shards)
            ]
        )

    out_cols = tuple(spread(c) for c in cols_s)
    rank = jnp.arange(capacity, dtype=jnp.int32)
    # a bucket slot past its segment's row count holds a neighbouring
    # segment's row (or pad zeros) — masked invalid here, never read
    bucket_valid = (
        rank[None, :] < jnp.minimum(hist, capacity)[:, None]
    ).reshape(-1)
    dropped = jnp.sum(jnp.maximum(hist - capacity, 0))
    return out_cols + (bucket_valid, dropped)


def _member_of_small(keys, small_keys, small_valid):
    """Per-row membership in a tiny key set: a fused broadcast-compare loop
    (|small| streaming passes over ``keys``) instead of a hashed-gather
    probe: for |small| ≲ 100 the fused compare passes stream ``keys`` once
    per entry with no per-row gather."""

    def body(j, acc):
        return acc | (small_valid[j] & (keys == small_keys[j]))

    return jax.lax.fori_loop(
        0, small_keys.shape[0], body, jnp.zeros(keys.shape, jnp.bool_)
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ShuffleStats:
    """Exactness accounting: any nonzero drop count means a retry is needed."""

    dropped_a: jax.Array
    dropped_b: jax.Array
    dropped_hot: jax.Array


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "cap_a", "cap_b", "hot_cap", "use_hot", "exchange_b"),
)
def _exchange(
    mesh: Mesh,
    keys_a,
    pays_a,
    keys_b,
    pays_b,
    shard_seed,
    hot_keys,
    hot_valid,
    hot_seed,
    cap_a: int,
    cap_b: int,
    hot_cap: int,
    use_hot: bool,
    exchange_b: bool = True,
    valid_a=None,
    valid_b=None,
):
    """Partition phase: bucketize + all_to_all both relations; replicate hot
    build rows.  Returns per-shard received rows (+ masks), local hot probe
    masks, replicated hot build rows, and drop stats.

    With ``exchange_b=False`` the B relation is bucketized but NOT exchanged
    (its slots in the return tuple hold the local send buckets) — the
    pipelined probe (_pipelined_probe) exchanges B chunk-by-chunk instead.

    ``valid_a``/``valid_b``: optional per-row validity (a pushed-down
    FILTER, the query layer's R2 rule).  Invalid rows route to the
    bucketizer's dump segment — they never travel, never replicate, and
    never appear hot — so a filtered distributed join costs zero extra
    passes."""

    def local(keys_a, pays_a, keys_b, pays_b, shard_seed, hot_keys, hot_valid, hot_seed, va, vb):
        num_shards = jax.lax.axis_size(SHARD_AXIS)
        shard_seed_ = shard_seed[0]
        row_a = jnp.ones(keys_a.shape, jnp.bool_) if va is None else va
        row_b = jnp.ones(keys_b.shape, jnp.bool_) if vb is None else vb
        if use_hot:
            # hot plan sets are <= hot_capacity keys: fused compare passes
            # beat a hashed-gather probe by ~10x on relation-sized inputs
            is_hot_a = row_a & _member_of_small(keys_a, hot_keys, hot_valid)
            is_hot_b = row_b & _member_of_small(keys_b, hot_keys, hot_valid)
        else:
            is_hot_a = jnp.zeros(keys_a.shape, jnp.bool_)
            is_hot_b = jnp.zeros(keys_b.shape, jnp.bool_)

        # cold rows travel to their owner shard
        dest_a = _owner_shard(keys_a, shard_seed_, num_shards)
        dest_b = _owner_shard(keys_b, shard_seed_, num_shards)
        bk_a, bp_a, bv_a, drop_a = _bucketize(
            dest_a, row_a & ~is_hot_a, cap_a, num_shards, keys_a, pays_a
        )
        bk_b, bp_b, bv_b, drop_b = _bucketize(
            dest_b, row_b & ~is_hot_b, cap_b, num_shards, keys_b, pays_b
        )

        def a2a(x):
            return jax.lax.all_to_all(
                x.reshape(num_shards, -1),
                SHARD_AXIS,
                split_axis=0,
                concat_axis=0,
            ).reshape(-1)

        rk_a, rp_a, rv_a = a2a(bk_a), a2a(bp_a), a2a(bv_a)
        if exchange_b:
            rk_b, rp_b, rv_b = a2a(bk_b), a2a(bp_b), a2a(bv_b)
        else:
            rk_b, rp_b, rv_b = bk_b, bp_b, bv_b

        # hot build rows are replicated everywhere (all_gather); hot probe
        # rows stay local (is_hot_b mask re-used in the probe phase)
        if use_hot:
            hot_sorted = jax.lax.sort(
                (jnp.where(is_hot_a, 0, 1), keys_a, pays_a),
                num_keys=1,
                is_stable=True,
            )
            n_hot = jnp.sum(is_hot_a.astype(jnp.int32))
            take = jnp.arange(hot_cap, dtype=jnp.int32)
            # hot_cap may exceed the local row count after an overflow retry
            # grows it; pad the compacted prefix to the static capacity
            local_n = keys_a.shape[0]
            slice_n = min(hot_cap, local_n)

            def fit(col):
                return jnp.zeros((hot_cap,), col.dtype).at[:slice_n].set(
                    col[:slice_n]
                )

            zero = jnp.zeros((hot_cap,), jnp.int32)
            hk_local = jnp.where(take < n_hot, fit(hot_sorted[1]), zero)
            hp_local = jnp.where(take < n_hot, fit(hot_sorted[2]), zero)
            hv_local = take < n_hot
            drop_hot = jnp.maximum(n_hot - hot_cap, 0)
            hk = jax.lax.all_gather(hk_local, SHARD_AXIS).reshape(-1)
            hp = jax.lax.all_gather(hp_local, SHARD_AXIS).reshape(-1)
            hv = jax.lax.all_gather(hv_local, SHARD_AXIS).reshape(-1)
        else:
            s = num_shards * hot_cap
            hk = jnp.zeros((s,), jnp.int32)
            hp = jnp.zeros((s,), jnp.int32)
            hv = jnp.zeros((s,), jnp.bool_)
            drop_hot = jnp.asarray(0, jnp.int32)

        stats = ShuffleStats(
            dropped_a=jax.lax.psum(drop_a, SHARD_AXIS),
            dropped_b=jax.lax.psum(drop_b, SHARD_AXIS),
            dropped_hot=jax.lax.psum(drop_hot, SHARD_AXIS),
        )
        return rk_a, rp_a, rv_a, rk_b, rp_b, rv_b, is_hot_b, hk, hp, hv, stats

    sh = P(SHARD_AXIS)
    rep = P()
    return _shard_map(
        local,
        mesh=mesh,
        in_specs=(sh, sh, sh, sh, rep, rep, rep, rep, sh, sh),
        out_specs=(sh, sh, sh, sh, sh, sh, sh, rep, rep, rep, rep),
        check_vma=False,
    )(
        keys_a,
        pays_a,
        keys_b,
        pays_b,
        jnp.reshape(shard_seed, (1,)),
        hot_keys,
        hot_valid,
        jnp.reshape(hot_seed, (1,)),
        valid_a,
        valid_b,
    )


@functools.partial(jax.jit, static_argnames=("mesh", "table_size"))
def _build_local_tables(mesh: Mesh, recv_keys_a, recv_valid_a, bucket_seed, table_size: int):
    """Build phase: one flat hash table per shard over received cold rows."""

    def local(keys, valid, seed):
        table = ht.build_hash_table(
            keys, seed[0], table_size, valid=valid, has_valid=True
        )
        return (
            table.slot_keys,
            table.slot_rows,
            jnp.reshape(table.max_probe, (1,)),
        )

    sh = P(SHARD_AXIS)
    return _shard_map(
        local,
        mesh=mesh,
        in_specs=(sh, sh, P()),
        out_specs=(sh, sh, sh),
        check_vma=False,
    )(recv_keys_a, recv_valid_a, jnp.reshape(bucket_seed, (1,)))


@functools.partial(jax.jit, static_argnames=("mesh", "use_hot"))
def _probe_and_count(
    mesh: Mesh,
    slot_keys,
    slot_rows,
    max_probes,
    bucket_seed,
    recv_keys_b,
    recv_valid_b,
    keys_b,
    is_hot_b,
    hot_plan_keys,
    hot_plan_valid,
    hot_repl_keys,
    hot_repl_valid,
    use_hot: bool,
):
    """Probe phase: cold rows vs local table, hot rows vs the effective hot
    plan set; psum for the global count (HashJoin.hpp:156's atomic analogue)."""
    eff_valid = _effective_hot_valid(
        use_hot, hot_plan_keys, hot_plan_valid, hot_repl_keys, hot_repl_valid
    )

    def local(slot_keys, slot_rows, max_probe, seed, rkb, rvb, kb, ihb, hpk, hpv):
        table = ht.HashTable(
            slot_keys=slot_keys,
            slot_rows=slot_rows,
            max_probe=max_probe[0],
            seed=seed[0],
        )
        found_cold = ht.probe_exists(table, rkb, valid=rvb)
        count = jnp.sum(found_cold.astype(jnp.int32))
        if use_hot:
            found_hot = ihb & _member_of_small(kb, hpk, hpv)
            count = count + jnp.sum(found_hot.astype(jnp.int32))
        return jnp.reshape(jax.lax.psum(count, SHARD_AXIS), (1,))

    sh = P(SHARD_AXIS)
    out = _shard_map(
        local,
        mesh=mesh,
        in_specs=(sh, sh, sh, P(), sh, sh, sh, sh, P(), P()),
        out_specs=P(),
        check_vma=False,
    )(
        slot_keys,
        slot_rows,
        max_probes,
        jnp.reshape(bucket_seed, (1,)),
        recv_keys_b,
        recv_valid_b,
        keys_b,
        is_hot_b,
        hot_plan_keys,
        eff_valid,
    )
    return out[0]



def _effective_hot_valid(
    use_hot: bool, hot_plan_keys, hot_plan_valid, hot_repl_keys, hot_repl_valid
):
    """Validity mask of the hot PLAN keys that actually have a replicated
    hot build row.  Probe-side membership against this masked plan set
    equals membership in the replicated hot build table (every replicated
    row's key is a plan key), so the hot probe needs no hash table at all —
    just |plan| fused compare passes (_member_of_small)."""
    if not use_hot:
        return jnp.zeros(hot_plan_keys.shape, jnp.bool_)
    present = jax.vmap(
        lambda k: jnp.any(hot_repl_valid & (hot_repl_keys == k))
    )(hot_plan_keys)
    return hot_plan_valid & present


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "cap_b", "use_hot", "num_chunks"),
)
def _pipelined_probe(
    mesh: Mesh,
    recv_keys_a,
    recv_valid_a,
    bucket_keys_b,
    bucket_valid_b,
    keys_b,
    is_hot_b,
    hot_plan_keys,
    hot_plan_valid,
    hot_repl_keys,
    hot_repl_valid,
    cap_b: int,
    use_hot: bool,
    num_chunks: int,
):
    """Probe with the B exchange split into round-robin chunks and software-
    pipelined against the local join (BASELINE "exchange overlapped with
    probe").  The scan body issues the NEXT chunk's ``all_to_all`` before
    counting the CURRENT chunk; the collective has no data dependence on the
    count, so XLA's async collective scheduling can overlap them.

    Chunk c takes the c-th CONTIGUOUS block of every bucket.  Buckets are
    static-capacity, so each chunk moves exactly cap_b/K rows per shard pair
    regardless of where the valid rows sit — chunk loads are even by
    construction.  (A round-robin rank striping would be equivalent but
    needs a (S, C/K, K) array with the small chunk count as its minor
    dimension, a layout that pads badly on tiled-memory devices.)

    The received build side is sorted ONCE before the chunk scan; each
    chunk then counts against the pre-sorted run by one vectorized
    searchsorted (``_searchsorted_counter``, ops/merge_join.py's INT32_MAX
    mask protocol).
    """
    eff_valid = _effective_hot_valid(
        use_hot, hot_plan_keys, hot_plan_valid, hot_repl_keys, hot_repl_valid
    )
    def local(rka, rva, bkb, bvb, kb, ihb, hpk, hpv):
        num_shards = jax.lax.axis_size(SHARD_AXIS)
        k_chunks = num_chunks
        # (S*C) -> (S, K, C//K): chunk k = k-th contiguous block per bucket.
        # The chunk axis is not minor, so no layout pads it
        bkb3 = bkb.reshape(num_shards, k_chunks, cap_b // k_chunks)
        bvb3 = bvb.reshape(num_shards, k_chunks, cap_b // k_chunks)

        def a2a(x):
            return jax.lax.all_to_all(
                x, SHARD_AXIS, split_axis=0, concat_axis=0
            )

        # sort the received build side ONCE, then count each chunk by one
        # vectorized searchsorted (re-sorting A inside every chunk would
        # cost K x the build sort)
        chunk_count = _searchsorted_counter(rka, rva)

        first = (a2a(bkb3[:, 0, :]), a2a(bvb3[:, 0, :]))

        def body(carry, k):
            rk, rv = carry
            # prefetch chunk k+1 — independent of this chunk's count
            next_rk = a2a(jnp.take(bkb3, k + 1, axis=1))
            next_rv = a2a(jnp.take(bvb3, k + 1, axis=1))
            cnt = chunk_count(rk.reshape(-1), rv.reshape(-1))
            return (next_rk, next_rv), cnt

        (last_rk, last_rv), counts = jax.lax.scan(
            body, first, jnp.arange(k_chunks - 1, dtype=jnp.int32)
        )
        # final chunk: already received by the last prefetch — count it
        # without issuing another exchange
        count = jnp.sum(counts) + chunk_count(
            last_rk.reshape(-1), last_rv.reshape(-1)
        )
        if use_hot:
            found_hot = ihb & _member_of_small(kb, hpk, hpv)
            count = count + jnp.sum(found_hot.astype(jnp.int32))
        return jnp.reshape(jax.lax.psum(count, SHARD_AXIS), (1,))

    sh = P(SHARD_AXIS)
    out = _shard_map(
        local,
        mesh=mesh,
        in_specs=(sh, sh, sh, sh, sh, sh, P(), P()),
        out_specs=P(),
        check_vma=False,
    )(
        recv_keys_a,
        recv_valid_a,
        bucket_keys_b,
        bucket_valid_b,
        keys_b,
        is_hot_b,
        hot_plan_keys,
        eff_valid,
    )
    return out[0]


def _searchsorted_member(rka, rva):
    """Sorted-set membership for a valid-masked key array: sort the set
    ONCE (INT32_MAX mask protocol — invalid rows sort past a ``limit``
    sentinel boundary), then answer any key batch with one vectorized
    searchsorted.  A query equal to INT32_MAX itself is answered exactly
    via the separate ``max_in_a`` flag (the set's masked region also holds
    INT32_MAX, so the limit test alone cannot see a real one).  Callers
    must mask the result by their own row validity."""
    i32_max = jnp.iinfo(jnp.int32).max
    a_eff = jnp.where(rva, rka, i32_max)
    a_sorted = jax.lax.sort((a_eff,), num_keys=1, is_stable=False)[0]
    max_in_a = jnp.any(rva & (rka == i32_max))
    limit = jnp.searchsorted(
        a_sorted, jnp.asarray(i32_max, jnp.int32), side="left"
    )

    def member(q):
        hit, idx = merge_join.sorted_position(a_sorted, q)
        return (hit & (idx < limit)) | (max_in_a & (q == i32_max))

    return member


def _searchsorted_counter(rka, rva):
    """Pre-sorted membership counter: the build set sorted ONCE (the
    two-run join's INT32_MAX mask protocol), each valid-masked probe batch
    then sorted and counted against it (the windowed probe on the GPU).
    Shared by the one-shot and pipelined local joins so their comparison
    isolates exchange structure, not local-join algorithm."""
    a_sorted, max_in_a = merge_join._prepare_build_i32(
        rka, rva, has_valid=True
    )

    def count(rk, rv):
        return merge_join._probe_prepared_i32(
            a_sorted, max_in_a, rk, rv, has_valid=True
        )

    return count


@functools.partial(jax.jit, static_argnames=("mesh", "use_hot"))
def _sort_merge_local_count(
    mesh: Mesh,
    recv_keys_a,
    recv_valid_a,
    recv_keys_b,
    recv_valid_b,
    keys_b,
    is_hot_b,
    hot_plan_keys,
    hot_plan_valid,
    hot_repl_keys,
    hot_repl_valid,
    use_hot: bool,
):
    """Fused local join: per-shard sort-merge count over received cold rows
    (the gather-free path, ops/sort_merge.py) + hot probe, psum'd.

    Replaces separate build/probe programs — the sort subsumes the build, so
    the shuffle join's post-exchange cost is one sort of the shard-local
    rows, mirroring the single-device two-run join."""
    eff_valid = _effective_hot_valid(
        use_hot, hot_plan_keys, hot_plan_valid, hot_repl_keys, hot_repl_valid
    )

    def local(rka, rva, rkb, rvb, kb, ihb, hpk, hpv):
        count = _searchsorted_counter(rka, rva)(rkb, rvb)
        if use_hot:
            found_hot = ihb & _member_of_small(kb, hpk, hpv)
            count = count + jnp.sum(found_hot.astype(jnp.int32))
        return jnp.reshape(jax.lax.psum(count, SHARD_AXIS), (1,))

    sh = P(SHARD_AXIS)
    out = _shard_map(
        local,
        mesh=mesh,
        in_specs=(sh, sh, sh, sh, sh, sh, P(), P()),
        out_specs=P(),
        check_vma=False,
    )(
        recv_keys_a,
        recv_valid_a,
        recv_keys_b,
        recv_valid_b,
        keys_b,
        is_hot_b,
        hot_plan_keys,
        eff_valid,
    )
    return out[0]


def plan_hot_keys(
    keys: jax.Array,
    sample_size: int,
    capacity: int,
    min_frac: float,
    seed: int = 0,
):
    """Sample-based heavy-hitter detection (SURVEY.md §7 step 7).

    Hashed-position sample of ``sample_size`` keys → GROUP BY count → top
    ``capacity`` keys with sample frequency ≥ ``min_frac``.  Returns
    (hot_keys int32[capacity], hot_valid bool[capacity]); deterministic
    given ``seed``, so every host computes the same plan.

    Sample positions are one per stride window, at a per-window hashed
    phase (position i*stride + hash(seed, i) % stride) — a plain
    stride-from-0 sample is blind to position-correlated inputs (e.g. a
    key-sorted relation whose hot keys sit in contiguous runs between the
    stride points, or an adversarial first-rows-special layout), while a
    hashed phase keeps full-window coverage AND positional randomness.
    """
    from partitionedhashjoin_tpu.ops.aggregate import _group_and_aggregate
    from partitionedhashjoin_tpu.ops.hashing import hash32

    n = keys.shape[0]
    stride = max(1, n // sample_size)
    m = min(n, sample_size)
    win = jnp.arange(m, dtype=jnp.int32)
    phase = (
        hash32(win, seed=(seed ^ 0x5EED) & 0xFFFFFFFF) % jnp.uint32(stride)
    ).astype(jnp.int32)
    pos = jnp.minimum(win * stride + phase, n - 1)
    sample = keys[pos]
    g = _group_and_aggregate(
        sample,
        jnp.zeros((m,), jnp.int32),
        jnp.asarray(seed & 0xFFFFFFFF, jnp.uint32),
        ht.table_size_for(m),
    )
    gid_valid = jnp.arange(m, dtype=jnp.int32) < g.num_groups
    counts = jnp.where(gid_valid, g.count, -1)
    k = min(capacity, m)  # top_k requires k <= array length
    top_counts, top_idx = jax.lax.top_k(counts, k)
    min_count = max(1, int(min_frac * m))
    hot_keys = jnp.zeros((capacity,), jnp.int32).at[:k].set(g.keys[top_idx])
    hot_valid = (
        jnp.zeros((capacity,), jnp.bool_).at[:k].set(top_counts >= min_count)
    )
    return hot_keys, hot_valid


class DistributedShuffleJoiner:
    """Mesh-parallel shuffle hash join driver.

    Phases map onto the reference timer (utils/results.py): partition =
    exchange (bucketize + all_to_all + hot replication), build = per-shard
    table build, probe = cold+hot probe with psum count.  ``slack`` controls
    static bucket capacity; on overflow the run retries with doubled slack
    (shapes recompile) so returned counts are always exact.
    """

    def __init__(
        self,
        mesh: Mesh,
        seed: Optional[int] = None,
        slack: float = 2.0,
        handle_skew: bool = True,
        hot_capacity: int = 64,
        hot_sample: int = 16_384,
        hot_min_frac: float = 0.005,
        max_retries: int = 3,
        local_join: str = "sort-merge",
        pipeline_chunks: int = 1,
        single_shard_fast_path: bool = True,
    ) -> None:
        if local_join not in ("sort-merge", "hash"):
            raise ValueError(f"unknown local_join {local_join}")
        if pipeline_chunks < 1:
            raise ValueError("pipeline_chunks must be >= 1")
        self._single_shard_fast_path = single_shard_fast_path
        self._local_join = local_join
        self._pipeline_chunks = pipeline_chunks
        self._mesh = mesh
        self._num_shards = int(mesh.devices.size)
        if self._num_shards & (self._num_shards - 1):
            raise ValueError("mesh size must be a power of 2")
        if seed is None:
            import numpy as _np

            seed = int(_np.random.SeedSequence().entropy & 0xFFFFFFFF)
        self._shard_seed = jnp.asarray(seed & 0xFFFFFFFF, jnp.uint32)
        self._bucket_seed = jnp.asarray(
            (seed ^ 0xC2B2AE35) & 0xFFFFFFFF, jnp.uint32
        )
        self._hot_seed = jnp.asarray(
            (seed ^ 0x9E3779B9) & 0xFFFFFFFF, jnp.uint32
        )
        self._slack = slack
        self._handle_skew = handle_skew
        self._hot_capacity = hot_capacity
        self._hot_sample = hot_sample
        self._hot_min_frac = hot_min_frac
        self._max_retries = max_retries
        self._logger = get_new_logger("DistributedShuffleJoiner")

    def _capacity(self, rows_per_shard: int, slack: float) -> int:
        per_dest = rows_per_shard / self._num_shards
        # a shard can never send more than its own rows to one destination,
        # so rows_per_shard is a hard cap (slack is meaningless at S=1)
        return max(16, min(int(per_dest * slack + 1), rows_per_shard))

    def run(
        self,
        table_a: Table,
        table_b: Table,
        timer: Optional[IHashJoinTimer] = None,
        valid_a=None,
        valid_b=None,
    ) -> int:
        """Count matches; ``valid_a``/``valid_b`` are optional per-row
        validity masks (a pushed-down FILTER — query.py R2/R6).  Invalid
        rows are dropped at the bucketizer so they never travel; the count
        is exact over valid rows only."""
        timer = timer or NoOpHashJoinTimer()
        s = self._num_shards
        if table_a.size % s or table_b.size % s:
            raise ValueError("relation sizes must divide the shard count")
        if (
            s == 1
            and self._single_shard_fast_path
            and self._local_join == "sort-merge"
            and self._pipeline_chunks == 1
        ):
            # shuffle elision: a 1-shard exchange is the identity, so the
            # join IS the local join (the single-partition special case
            # every shuffle engine short-circuits).  Hot-key replication
            # is likewise a no-op — there is no imbalance to spread.
            # Disable via single_shard_fast_path=False to measure the
            # exchange machinery itself.
            from partitionedhashjoin_tpu.ops.sort_merge import (
                SortMergeJoiner,
                sort_merge_count,
            )

            timer.set_partitioning_phase_begin()
            timer.set_partitioning_phase_end()
            timer.set_build_phase_begin()
            timer.set_build_phase_end()
            timer.set_probe_phase_begin()
            wide = (jnp.int64, jnp.uint64)
            i64 = (
                jnp.asarray(table_a.keys).dtype in wide
                or jnp.asarray(table_b.keys).dtype in wide
            )
            masked = valid_a is not None or valid_b is not None
            if not masked:
                count = SortMergeJoiner.count(table_a.keys, table_b.keys)
            elif not i64:
                count = merge_join.two_run_count(
                    table_a.keys, table_b.keys,
                    build_valid=valid_a, probe_valid=valid_b,
                )
            else:
                count = sort_merge_count(
                    table_a.keys, table_b.keys,
                    build_valid=valid_a, probe_valid=valid_b,
                )
            count = int(jax.device_get(count))
            timer.set_probe_phase_end()
            self._logger.info("Number of joined tuples: %d", count)
            return count
        use_hot = self._handle_skew
        if use_hot:
            hot_keys, hot_valid = plan_hot_keys(
                table_b.keys,
                self._hot_sample,
                self._hot_capacity,
                self._hot_min_frac,
                seed=int(self._hot_seed),
            )
        else:
            hot_keys = jnp.zeros((self._hot_capacity,), jnp.int32)
            hot_valid = jnp.zeros((self._hot_capacity,), jnp.bool_)

        slack = self._slack
        hot_cap = self._hot_capacity
        pipelined = self._pipeline_chunks > 1
        partition_seconds = 0.0  # accumulates across overflow retries
        for attempt in range(self._max_retries):
            cap_a = self._capacity(table_a.size // s, slack)
            cap_b = self._capacity(table_b.size // s, slack)
            if pipelined:
                k = self._pipeline_chunks
                cap_b = (cap_b + k - 1) // k * k

            import time as _time

            attempt_t0 = _time.perf_counter()
            (
                rk_a, rp_a, rv_a, rk_b, rp_b, rv_b,
                is_hot_b, hk, hp, hv, stats,
            ) = _exchange(
                self._mesh,
                table_a.keys,
                table_a.payloads,
                table_b.keys,
                table_b.payloads,
                self._shard_seed,
                hot_keys,
                hot_valid,
                self._hot_seed,
                cap_a,
                cap_b,
                hot_cap,
                use_hot,
                exchange_b=not pipelined,
                valid_a=valid_a,
                valid_b=valid_b,
            )
            dropped = jax.device_get(
                (stats.dropped_a, stats.dropped_b, stats.dropped_hot)
            )
            # accumulate across retries: overwriting would silently hide the
            # device work spent on failed attempts (discontinuous-segment
            # accounting, the reference's TimeSegmentMeasurer use case)
            partition_seconds += _time.perf_counter() - attempt_t0
            timer.set_partitioning_phase_duration(partition_seconds)
            if any(int(d) > 0 for d in dropped):
                self._logger.info(
                    "bucket overflow (a=%d b=%d hot=%d) at slack %.1f; retrying",
                    int(dropped[0]), int(dropped[1]), int(dropped[2]), slack,
                )
                # grow the capacity that actually overflowed: doubling slack
                # cannot fix a hot-replication overflow (hot_cap is separate)
                if int(dropped[0]) > 0 or int(dropped[1]) > 0:
                    slack *= 2
                if int(dropped[2]) > 0:
                    hot_cap = hot_cap * 4 + int(dropped[2])
                continue

            if pipelined:
                # B buckets exchanged chunk-by-chunk, overlapped with the
                # per-chunk local join inside one scanned program
                timer.set_build_phase_begin()
                timer.set_build_phase_end()
                timer.set_probe_phase_begin()
                count = _pipelined_probe(
                    self._mesh,
                    rk_a,
                    rv_a,
                    rk_b,
                    rv_b,
                    table_b.keys,
                    is_hot_b,
                    hot_keys,
                    hot_valid,
                    hk,
                    hv,
                    cap_b,
                    use_hot,
                    self._pipeline_chunks,
                )
                count = int(jax.device_get(count))
                timer.set_probe_phase_end()
            elif self._local_join == "sort-merge":
                # the sort subsumes the build: one fused local-join program
                timer.set_build_phase_begin()
                timer.set_build_phase_end()
                timer.set_probe_phase_begin()
                count = _sort_merge_local_count(
                    self._mesh,
                    rk_a,
                    rv_a,
                    rk_b,
                    rv_b,
                    table_b.keys,
                    is_hot_b,
                    hot_keys,
                    hot_valid,
                    hk,
                    hv,
                    use_hot,
                )
                count = int(jax.device_get(count))
                timer.set_probe_phase_end()
            else:
                table_size = ht.table_size_for(s * cap_a)
                timer.set_build_phase_begin()
                slot_keys, slot_rows, max_probes = _build_local_tables(
                    self._mesh, rk_a, rv_a, self._bucket_seed, table_size
                )
                jax.block_until_ready(slot_rows)
                timer.set_build_phase_end()

                timer.set_probe_phase_begin()
                count = _probe_and_count(
                    self._mesh,
                    slot_keys,
                    slot_rows,
                    max_probes,
                    self._bucket_seed,
                    rk_b,
                    rv_b,
                    table_b.keys,
                    is_hot_b,
                    hot_keys,
                    hot_valid,
                    hk,
                    hv,
                    use_hot,
                )
                count = int(jax.device_get(count))
                timer.set_probe_phase_end()
            self._logger.info("Number of joined tuples: %d", count)
            return count
        raise RuntimeError(
            f"shuffle buckets overflowed after {self._max_retries} retries"
        )

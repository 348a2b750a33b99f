"""Distributed GROUP BY over the device mesh — combiner design.

Scale-out of the sort-based aggregate (ops/aggregate.py), the way real
engines shard GROUP BY.  The naive plan (hash-route every ROW to its
key's owner shard, aggregate there) moves the whole relation and melts
under Zipf heads (the hot key's owner receives ~21 % of ALL rows at
α=1.25).  This module runs the classic two-level plan instead:

  1. **local combiner**: each shard aggregates its own slice with the
     engine's sort-based aggregate — one partial (key, count, sum, min,
     max) per distinct key per shard, capacity-bounded with the exact
     ``num_groups`` overflow contract;
  2. **partial exchange**: partials (never rows) are hash-routed by key
     through the same streaming bucketize + ``all_to_all`` the shuffle
     join uses — exchange volume is bounded by distinct keys per shard,
     and a hot key is ONE partial per shard regardless of its row count,
     so skew cannot unbalance the exchange *by construction*;
  3. **local merge**: each shard owns a disjoint key range (hash
     ownership) and merges its received partials — counts/sums add,
     mins/maxes fold — so global results are exact without any
     cross-shard reduction beyond the exchange itself.

Static capacities everywhere, overflow counters + doubled-slack retries
for exactness (the engine-wide protocol, parallel/shuffle.py).  The
reference has no aggregate operator at all (its aggregation analogue is
the per-thread match counters summed at join end,
src/NoPartitioning/HashJoin.hpp:292-300); this is the engine-extension
operator (ops/aggregate.py) made mesh-parallel.

group_of_row is a single-device feature.  COUNT DISTINCT takes the
row-exchange plan instead of the combiner (``with_distinct=True``):
distinct of a payload cannot be merged from per-shard distinct counts,
so rows travel to their key's owner shard and one local distinct
aggregate runs there — exact by construction, with the capacity retries
absorbing skew (see ``_row_exchange_aggregate``).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from partitionedhashjoin_tpu.data.table import Table
from partitionedhashjoin_tpu.ops import hashing
from partitionedhashjoin_tpu.ops.aggregate import (
    GroupByResult,
    _seg_suffix_scan,
    _scatter_compaction,
    _sort_group_and_aggregate,
)
from partitionedhashjoin_tpu.parallel.mesh import SHARD_AXIS
from partitionedhashjoin_tpu.parallel.shuffle import _bucketize, _shard_map
from partitionedhashjoin_tpu.utils.logger import get_new_logger

_I32_MAX = jnp.iinfo(jnp.int32).max


def _merge_partials(key, cnt, sm, mn, mx, valid, cap: int):
    """Merge received per-shard partials that share a key: counts and sums
    ADD, mins/maxes FOLD.  One small unstable sort groups equal keys
    (partial arrays are distinct-key-sized, not relation-sized), then the
    aggregate's boundary-cumsum scheme handles the additive columns and
    two segmented suffix scans fold min/max (payload-order tricks do not
    apply — there are two independent extreme columns here).

    Returns (gkey, gcnt, gsum, gmin, gmax, num_groups) with a zeroed tail
    past ``num_groups`` (arrays of static length ``cap``).
    """
    n = key.shape[0]
    inv = jnp.where(valid, 0, 1).astype(jnp.int32)
    iota = jnp.arange(n, dtype=jnp.int32)
    inv_s, key_s, cnt_s, sm_s, mn_s, mx_s = jax.lax.sort(
        (inv, key, cnt, sm, mn, mx), num_keys=2, is_stable=False
    )
    valid_s = inv_s == 0
    n_valid = jnp.sum(valid_s.astype(jnp.int32))
    prev_key = jnp.concatenate([key_s[:1], key_s[:-1]])
    is_start = valid_s & ((iota == 0) | (key_s != prev_key))
    num_groups = jnp.sum(is_start.astype(jnp.int32))

    nxt_valid = jnp.concatenate([valid_s[1:], jnp.zeros((1,), jnp.bool_)])
    nxt_key = jnp.concatenate([key_s[1:], key_s[-1:]])
    is_end = valid_s & (~nxt_valid | (nxt_key != key_s))
    seg_min = _seg_suffix_scan(mn_s, is_end, jnp.minimum)
    seg_max = _seg_suffix_scan(mx_s, is_end, jnp.maximum)

    csc = jnp.cumsum(cnt_s, dtype=cnt.dtype)
    cscx = csc - cnt_s
    css = jnp.cumsum(sm_s, dtype=sm.dtype)
    cssx = css - sm_s

    flag = jnp.where(is_start, 0, 1).astype(jnp.int32)
    _, s_full, gkey, gmin, gmax, gcscx, gcssx = jax.lax.sort(
        (flag, iota, key_s, seg_min, seg_max, cscx, cssx),
        num_keys=2, is_stable=False,
    )

    g = jnp.arange(cap, dtype=jnp.int32)
    g_ok = g < num_groups
    has_next = g + 1 < num_groups
    zero1 = jnp.zeros((1,), jnp.int32)

    def shift(col):
        return jnp.concatenate([col[1:cap + 1], zero1.astype(col.dtype)])[:cap]

    total_cnt = jnp.sum(jnp.where(valid_s, cnt_s, 0), dtype=cnt.dtype)
    total_sm = jnp.sum(jnp.where(valid_s, sm_s, 0), dtype=sm.dtype)
    cnt_hi = jnp.where(has_next, shift(gcscx), total_cnt)
    sm_hi = jnp.where(has_next, shift(gcssx), total_sm)
    zero = jnp.int32(0)
    return (
        jnp.where(g_ok, gkey[:cap], zero),
        jnp.where(g_ok, cnt_hi - gcscx[:cap], zero),
        jnp.where(g_ok, sm_hi - gcssx[:cap], zero),
        jnp.where(g_ok, gmin[:cap], zero),
        jnp.where(g_ok, gmax[:cap], zero),
        num_groups,
    )


def _route_and_merge_partials(g, p_valid, seed, cap_x: int, cap_merge: int):
    """Inside ``shard_map``: hash-route this shard's partial aggregates to
    their key's owner shard (streaming bucketize + ``all_to_all``) and merge
    the received partials.  Returns (mk, mc, ms, mmn, mmx, m_num, dropped);
    shared by the plain distributed GROUP BY and the join→GROUP BY
    (parallel/join_aggregate.py), whose local stages differ but whose
    partial plumbing is identical."""
    num_shards = jax.lax.axis_size(SHARD_AXIS)
    dest = hashing.bucket(hashing.hash32(g.keys, seed), num_shards)
    bk, bc, bs, bmn, bmx, bv, dropped = _bucketize(
        dest, p_valid, cap_x, num_shards,
        g.keys, g.count, g.sum, g.min, g.max,
    )

    def a2a(x):
        return jax.lax.all_to_all(
            x.reshape(num_shards, -1),
            SHARD_AXIS,
            split_axis=0,
            concat_axis=0,
        ).reshape(-1)

    rk, rc, rs, rmn, rmx, rv = map(a2a, (bk, bc, bs, bmn, bmx, bv))
    mk, mc, ms, mmn, mmx, m_num = _merge_partials(
        rk, rc, rs, rmn, rmx, rv, cap_merge
    )
    return mk, mc, ms, mmn, mmx, m_num, dropped


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "cap_local", "cap_x", "cap_merge"),
)
def _aggregate_exchange(
    mesh: Mesh,
    keys,
    pays,
    valid,
    shard_seed,
    cap_local: int,
    cap_x: int,
    cap_merge: int,
):
    """One program: per-shard combiner aggregate, partial bucket exchange,
    per-shard merge.  Returns per-shard merged group columns (sharded,
    ``cap_merge`` rows each), per-shard merged group counts, plus global
    exactness telemetry: the max per-shard combiner group count (the
    EXACT capacity the retry needs), total dropped partials, and the max
    per-shard merged group count."""

    def local(keys, pays, valid, shard_seed):
        seed = shard_seed[0]
        g = _sort_group_and_aggregate(
            keys[0], pays[0], cap_local,
            valid=valid[0], has_valid=True,
            scatter_compaction=_scatter_compaction("auto"),
        )
        # exact need, not a flag: one retry then lands the right capacity
        local_need = g.num_groups
        slot = jnp.arange(cap_local, dtype=jnp.int32)
        p_valid = slot < g.num_groups
        mk, mc, ms, mmn, mmx, m_num, dropped = _route_and_merge_partials(
            g, p_valid, seed, cap_x, cap_merge
        )
        return (
            mk[None], mc[None], ms[None], mmn[None], mmx[None],
            m_num[None],
            jax.lax.pmax(local_need, SHARD_AXIS),
            jax.lax.psum(dropped, SHARD_AXIS),
            jax.lax.pmax(m_num, SHARD_AXIS),
        )

    sh = P(SHARD_AXIS)
    rep = P()
    return _shard_map(
        local,
        mesh=mesh,
        in_specs=(sh, sh, sh, rep),
        out_specs=(sh, sh, sh, sh, sh, sh, rep, rep, rep),
        check_vma=False,
    )(
        keys.reshape(mesh.devices.size, -1),
        pays.reshape(mesh.devices.size, -1),
        valid.reshape(mesh.devices.size, -1),
        jnp.reshape(shard_seed, (1,)),
    )


@functools.partial(jax.jit, static_argnames=("num_shards", "cap_merge"))
def _gather_groups(mk, mc, ms, mmn, mmx, m_nums, num_shards: int,
                   cap_merge: int):
    """Compact the per-shard merged groups into one global valid prefix
    (keys are disjoint across shards by hash ownership, so concatenation
    IS the global result; one small stable-partition sort packs the
    per-shard valid prefixes together)."""
    from partitionedhashjoin_tpu.ops.filter import compact_sort

    slot = jnp.arange(cap_merge, dtype=jnp.int32)
    valid = (slot[None, :] < m_nums[:, None]).reshape(-1)
    count, k, c, s, mn, mx = compact_sort(
        valid, mk.reshape(-1), mc.reshape(-1), ms.reshape(-1),
        mmn.reshape(-1), mmx.reshape(-1),
    )
    live = jnp.arange(k.shape[0], dtype=jnp.int32) < count
    zero = jnp.int32(0)
    return (
        jnp.where(live, k, zero),
        jnp.where(live, c, zero),
        jnp.where(live, s, zero),
        jnp.where(live, mn, zero),
        jnp.where(live, mx, zero),
        count,
    )


class DistributedAggregateOperator:
    """Mesh-parallel GROUP BY driver.

    ``run(table, group_capacity)`` returns a replicated ``GroupByResult``
    identical (as a key → aggregates map; group order is shard-hash order)
    to ``ops.aggregate.sort_aggregate`` on the unsharded table.  The table
    may be sharded already (``parallel.mesh.shard_table``) or host-global.

    Exactness: three counters guard the three static capacities (local
    combiner groups, exchange buckets, merged groups); any overflow
    doubles the corresponding slack and retries.  int32 keys/payloads
    (sums mod 2^32, matching the single-device paths bit-exactly).
    """

    def __init__(
        self,
        mesh: Mesh,
        seed: Optional[int] = None,
        slack: float = 2.0,
        max_retries: int = 5,
    ) -> None:
        self._mesh = mesh
        self._num_shards = int(mesh.devices.size)
        if self._num_shards & (self._num_shards - 1):
            raise ValueError("mesh size must be a power of 2")
        if seed is None:
            import numpy as _np

            seed = int(_np.random.SeedSequence().entropy & 0xFFFFFFFF)
        self._shard_seed = jnp.asarray(seed & 0xFFFFFFFF, jnp.uint32)
        self._slack = slack
        self._max_retries = max_retries
        self._logger = get_new_logger("DistributedAggregate")

    def run(
        self,
        table: Table,
        group_capacity: Optional[int] = None,
        mask=None,
        with_distinct: bool = False,
    ) -> GroupByResult:
        """``mask``: optional per-row validity (a pushed-down FILTER — the
        query layer's R2 rule); masked-out rows are excluded exactly, via
        the same validity column that already absorbs the shard padding,
        so a distributed filter→GROUP BY costs zero extra passes.

        ``with_distinct``: exact COUNT(DISTINCT payload) per group via the
        row-exchange plan (``_row_exchange_aggregate``) — per-shard
        distinct counts cannot be merged, so rows (not partials) travel
        to their key's owner shard; the capacity retries absorb skew."""
        if table.keys.dtype != jnp.int32 or table.payloads.dtype != jnp.int32:
            raise TypeError(
                "distributed aggregate is int32-only (keys "
                f"{table.keys.dtype}, payloads {table.payloads.dtype})"
            )
        n = table.size
        s = self._num_shards
        if n == 0:
            z = jnp.zeros((0,), jnp.int32)
            return GroupByResult(
                keys=z, count=z, sum=z, min=z, max=z,
                num_groups=jnp.asarray(0, jnp.int32),
                group_of_row=z,
            )
        padded = (n + s - 1) // s * s
        keys, pays = table.keys, table.payloads
        if padded != n:
            pad = padded - n
            keys = jnp.concatenate([keys, jnp.zeros((pad,), keys.dtype)])
            pays = jnp.concatenate([pays, jnp.zeros((pad,), pays.dtype)])
        valid = jnp.arange(padded, dtype=jnp.int32) < n
        if mask is not None:
            m = jnp.asarray(mask, jnp.bool_)
            if m.shape != (n,):
                raise ValueError(
                    f"mask shape {m.shape} must match table rows ({n},)"
                )
            if padded != n:
                m = jnp.concatenate(
                    [m, jnp.zeros((padded - n,), jnp.bool_)]
                )
            valid = valid & m
        per_shard = padded // s
        if with_distinct:
            return self._run_distinct(
                keys, pays, valid, n, per_shard, group_capacity
            )
        hint = per_shard if group_capacity is None else min(
            group_capacity, per_shard
        )

        cap_local = max(16, min(hint, per_shard))
        cap_merge_floor = 16
        slack = self._slack
        for _ in range(self._max_retries):
            # exchange capacity: cap_local partials spread over s buckets
            cap_x = max(16, min(int(cap_local / s * slack + 1), cap_local))
            # merged capacity: this shard owns ~1/s of global keys; it can
            # receive at most s partials per owned key
            cap_merge = max(
                cap_merge_floor,
                min(int(cap_local * slack + 1), s * cap_x),
            )
            mk, mc, ms, mmn, mmx, m_nums, l_need, dropped, m_need = (
                _aggregate_exchange(
                    self._mesh, keys, pays, valid, self._shard_seed,
                    cap_local, cap_x, cap_merge,
                )
            )
            l_need, dropped, m_need = (
                int(jax.device_get(l_need)),
                int(jax.device_get(dropped)),
                int(jax.device_get(m_need)),
            )
            if l_need <= cap_local and dropped == 0 and m_need <= cap_merge:
                k, c, sm, mn, mx, count = _gather_groups(
                    mk, mc, ms, mmn, mmx, m_nums,
                    num_shards=s, cap_merge=cap_merge,
                )
                num = jnp.asarray(count, jnp.int32)
                self._logger.info(
                    "Number of groups: %d", int(jax.device_get(num))
                )
                return GroupByResult(
                    keys=k, count=c, sum=sm, min=mn, max=mx,
                    num_groups=num,
                    group_of_row=jnp.full((n,), -1, jnp.int32),
                )
            self._logger.info(
                "capacity overflow (local need=%d/%d, dropped=%d, merge "
                "need=%d/%d) at slack %.1f; retrying",
                l_need, cap_local, dropped, m_need, cap_merge, slack,
            )
            if l_need > cap_local:
                cap_local = min(per_shard, max(l_need, cap_local * 2))
            if m_need > cap_merge:
                cap_merge_floor = max(m_need, cap_merge * 2)
            if dropped:
                slack *= 2
        raise RuntimeError(
            f"aggregate capacity overflow persisted after "
            f"{self._max_retries} retries (final slack {slack:.1f})"
        )

    def _run_distinct(
        self, keys, pays, valid, n: int, per_shard: int,
        group_capacity: Optional[int],
    ) -> GroupByResult:
        """Exact COUNT DISTINCT: row exchange + local distinct aggregate
        (see ``_row_exchange_aggregate`` for why rows must travel)."""
        s = self._num_shards
        hint = per_shard if group_capacity is None else min(
            group_capacity, s * per_shard
        )
        cap_groups = max(16, hint)
        slack = self._slack
        for _ in range(self._max_retries):
            # per-destination bucket capacity; a shard cannot send more
            # than its own rows to one destination
            cap_rows = max(16, min(int(per_shard / s * slack + 1), per_shard))
            cap_groups = min(cap_groups, s * cap_rows)
            gk, gc, gs, gmn, gmx, gd, g_nums, dropped, g_need = (
                _row_exchange_aggregate(
                    self._mesh, keys, pays, valid, self._shard_seed,
                    cap_rows, cap_groups,
                )
            )
            dropped, g_need = (
                int(jax.device_get(dropped)),
                int(jax.device_get(g_need)),
            )
            if dropped == 0 and g_need <= cap_groups:
                k, c, sm, mn, mx, d, count = _gather_groups_distinct(
                    gk, gc, gs, gmn, gmx, gd, g_nums,
                    cap_groups=cap_groups,
                )
                num = jnp.asarray(count, jnp.int32)
                self._logger.info(
                    "Number of groups: %d", int(jax.device_get(num))
                )
                return GroupByResult(
                    keys=k, count=c, sum=sm, min=mn, max=mx,
                    num_groups=num,
                    group_of_row=jnp.full((n,), -1, jnp.int32),
                    distinct=d,
                )
            self._logger.info(
                "distinct-plan overflow (dropped=%d, group need=%d/%d) at "
                "slack %.1f; retrying",
                dropped, g_need, cap_groups, slack,
            )
            if dropped:
                slack *= 2
            if g_need > cap_groups:
                cap_groups = max(g_need, cap_groups * 2)
        raise RuntimeError(
            f"distinct-plan capacity overflow persisted after "
            f"{self._max_retries} retries"
        )


@functools.partial(
    jax.jit, static_argnames=("mesh", "cap_rows", "cap_groups")
)
def _row_exchange_aggregate(
    mesh: Mesh, keys, pays, valid, shard_seed,
    cap_rows: int, cap_groups: int,
):
    """Row-exchange plan (the distinct path): hash-route ROWS to their
    key's owner shard, then one local sort-aggregate with
    ``with_distinct=True`` — every group's rows (and payload values) meet
    at one shard, so distinct counts are exact by construction.

    This is the plan the combiner design deliberately avoids for the
    additive aggregates (module docstring): it moves the whole relation
    and a Zipf head's owner receives every one of its rows.  COUNT
    DISTINCT fundamentally needs the payload SETS together (per-shard
    distinct counts cannot be merged), so the row exchange is the honest
    price of exactness — and the capacity-retry contract absorbs the
    skew (the hot shard's bucket capacity grows until it fits).
    """

    def local(keys, pays, valid, shard_seed):
        num_shards = jax.lax.axis_size(SHARD_AXIS)
        seed = shard_seed[0]
        dest = hashing.bucket(hashing.hash32(keys[0], seed), num_shards)
        bk, bp, bv, dropped = _bucketize(
            dest, valid[0], cap_rows, num_shards, keys[0], pays[0]
        )

        def a2a(x):
            return jax.lax.all_to_all(
                x.reshape(num_shards, -1),
                SHARD_AXIS,
                split_axis=0,
                concat_axis=0,
            ).reshape(-1)

        rk, rp, rv = a2a(bk), a2a(bp), a2a(bv)
        g = _sort_group_and_aggregate(
            rk, rp, cap_groups,
            valid=rv, has_valid=True,
            scatter_compaction=_scatter_compaction("auto"),
            with_distinct=True,
        )
        return (
            g.keys[None], g.count[None], g.sum[None],
            g.min[None], g.max[None], g.distinct[None],
            g.num_groups[None],
            jax.lax.psum(dropped, SHARD_AXIS),
            jax.lax.pmax(g.num_groups, SHARD_AXIS),
        )

    sh = P(SHARD_AXIS)
    rep = P()
    return _shard_map(
        local,
        mesh=mesh,
        in_specs=(sh, sh, sh, rep),
        out_specs=(sh, sh, sh, sh, sh, sh, sh, rep, rep),
        check_vma=False,
    )(
        keys.reshape(mesh.devices.size, -1),
        pays.reshape(mesh.devices.size, -1),
        valid.reshape(mesh.devices.size, -1),
        jnp.reshape(shard_seed, (1,)),
    )


@functools.partial(jax.jit, static_argnames=("cap_groups",))
def _gather_groups_distinct(gk, gc, gs, gmn, gmx, gd, g_nums,
                            cap_groups: int):
    """Like ``_gather_groups`` with the distinct column riding along."""
    from partitionedhashjoin_tpu.ops.filter import compact_sort

    slot = jnp.arange(cap_groups, dtype=jnp.int32)
    valid = (slot[None, :] < g_nums[:, None]).reshape(-1)
    count, k, c, s, mn, mx, d = compact_sort(
        valid, gk.reshape(-1), gc.reshape(-1), gs.reshape(-1),
        gmn.reshape(-1), gmx.reshape(-1), gd.reshape(-1),
    )
    live = jnp.arange(k.shape[0], dtype=jnp.int32) < count
    zero = jnp.int32(0)
    return (
        jnp.where(live, k, zero),
        jnp.where(live, c, zero),
        jnp.where(live, s, zero),
        jnp.where(live, mn, zero),
        jnp.where(live, mx, zero),
        jnp.where(live, d, zero),
        count,
    )

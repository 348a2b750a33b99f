"""Distributed join → GROUP BY over the device mesh (one shuffle, no
re-shuffle).

The single-device R3 plan (query.py: join → GROUP BY with the relation
sort skipped) made the composed pipeline the engine's headline extension;
this module is its scale-out.  The reference has neither operator — its
one pipeline is generate → join → count (src/main.cpp:210-293) on shared
memory — so the design target is the engine's own exactness contract and
the scaling blueprint (SURVEY.md §7 step 6).

Key observation: **the join's exchange already co-partitions the GROUP BY.**
Grouping is by the join key, and the shuffle join hash-routes both
relations by that key (parallel/shuffle.py), so after the exchange every
cold group lives wholly on one shard — a second row shuffle would move
the data again for nothing.  The plan:

  1. **Exchange** — the shuffle join's ``_exchange`` verbatim: cold rows
     to ``hash(key) % S``, hot build rows replicated (``all_gather``),
     hot probe rows stay local (Zipf heads never travel).
  2. **Local partial aggregate** — each shard aggregates ALL its probe
     rows (received cold + local hot) with the combiner's one-sort
     aggregate.  No per-row match pass exists at all: matching is decided
     per PARTIAL (distinct-key-sized, not relation-sized) by membership
     of the partial's key in the received cold build set (one sorted-set
     ``searchsorted`` over the build keys) or the replicated hot set
     (fused broadcast compares).  Unmatched keys' partials are zeroed
     before the partial exchange — semantically the inner join's
     first-match filter, applied at group granularity.
  3. **Partial exchange + merge** — the distributed GROUP BY's combiner
     plumbing verbatim (``_route_and_merge_partials``): cold partials
     are already on their owner shard, hot-key partials (one per shard,
     regardless of row count) merge by add/fold.

Exactness: the engine-wide static-capacity protocol.  Five counters guard
five capacities (cold bucket a/b, hot replication, local partial groups,
partial-exchange buckets, merged groups); any overflow grows the specific
capacity and retries, so results are always exact.

Semantics: inner join, aggregates over the PROBE payload (query.py
``carry="probe"``) — each probe row whose key exists in the build side
contributes once, which is exactly the single-device first-match
materialize → GROUP BY result.  ``carry="build"`` stays single-device:
with duplicate build keys "the matched build payload" is
implementation-defined, and a distributed MIN/MAX over an unspecified
choice cannot be promised exact.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from partitionedhashjoin_tpu.data.table import Table
from partitionedhashjoin_tpu.ops.aggregate import (
    GroupByResult,
    _scatter_compaction,
    _sort_group_and_aggregate,
)
from partitionedhashjoin_tpu.parallel.aggregate_shuffle import (
    _gather_groups,
    _route_and_merge_partials,
)
from partitionedhashjoin_tpu.parallel.mesh import SHARD_AXIS
from partitionedhashjoin_tpu.parallel.shuffle import (
    _effective_hot_valid,
    _exchange,
    _member_of_small,
    _searchsorted_member,
    _shard_map,
    plan_hot_keys,
)
from partitionedhashjoin_tpu.utils.logger import get_new_logger


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "use_hot", "cap_local", "cap_x", "cap_merge"),
)
def _join_aggregate_local(
    mesh: Mesh,
    rk_a,
    rv_a,
    rk_b,
    rp_b,
    rv_b,
    keys_b,
    pays_b,
    is_hot_b,
    hot_plan_keys,
    eff_hot_valid,
    agg_seed,
    use_hot: bool,
    cap_local: int,
    cap_x: int,
    cap_merge: int,
):
    """Local join-aggregate + partial exchange + merge, one program.

    Per shard: one sort-based partial aggregate over the concatenated
    (received cold probe rows, local hot probe rows) with row validity
    (bucket padding; hot rows additionally pre-filtered by membership in
    the effective replicated hot set), then partials whose key has no
    build row are invalidated — cold presence from the received build
    set, hot presence from the hot plan.  Returns sharded merged groups
    plus the exactness telemetry (local need, dropped partials, merge
    need)."""

    def local(rka, rva, rkb, rpb, rvb, kb, pb, ihb, hpk, hpv, seed):
        # hot probe rows: valid only when their key actually has a
        # replicated hot build row (plan keys absent from the build side
        # are dead — _effective_hot_valid masked them already)
        if use_hot:
            hot_match = ihb & _member_of_small(kb, hpk, hpv)
        else:
            hot_match = jnp.zeros(kb.shape, jnp.bool_)
        keys = jnp.concatenate([rkb, kb])
        pays = jnp.concatenate([rpb, pb])
        valid = jnp.concatenate([rvb, hot_match])
        g = _sort_group_and_aggregate(
            keys, pays, cap_local,
            valid=valid, has_valid=True,
            scatter_compaction=_scatter_compaction("auto"),
        )
        local_need = g.num_groups
        slot = jnp.arange(cap_local, dtype=jnp.int32)
        # the inner join at group granularity: a partial survives iff its
        # key exists in the build side.  Hot-plan keys were never
        # exchanged cold on EITHER side (the same plan gates both
        # relations), so the two presence sets are disjoint by
        # construction and one OR is exact.
        present = _searchsorted_member(rka, rva)(g.keys)
        if use_hot:
            present = present | _member_of_small(g.keys, hpk, hpv)
        p_valid = (slot < g.num_groups) & present
        mk, mc, ms, mmn, mmx, m_num, dropped = _route_and_merge_partials(
            g, p_valid, seed[0], cap_x, cap_merge
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
        in_specs=(sh, sh, sh, sh, sh, sh, sh, sh, rep, rep, rep),
        out_specs=(sh, sh, sh, sh, sh, sh, rep, rep, rep),
        check_vma=False,
    )(
        rk_a, rv_a, rk_b, rp_b, rv_b, keys_b, pays_b, is_hot_b,
        hot_plan_keys, eff_hot_valid, jnp.reshape(agg_seed, (1,)),
    )


class DistributedJoinAggregateOperator:
    """Mesh-parallel inner-join → GROUP BY driver.

    ``run(build, probe)`` returns a replicated ``GroupByResult`` equal
    (as a key → aggregates map) to the single-device composed plan
    ``scan(probe).join(scan(build)).group_by()`` with ``carry="probe"``:
    COUNT/SUM/MIN/MAX of the probe payload over probe rows whose key
    exists in the build relation.

    Shares the shuffle join's exchange knobs (slack, skew plan) and the
    distributed aggregate's capacity contract; every static capacity has
    an overflow counter and a growing retry, so results are exact.
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
        self._agg_seed = jnp.asarray(
            (seed ^ 0x85EBCA6B) & 0xFFFFFFFF, jnp.uint32
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
        self._logger = get_new_logger("DistributedJoinAggregate")

    def _capacity(self, rows_per_shard: int, slack: float) -> int:
        per_dest = rows_per_shard / self._num_shards
        return max(16, min(int(per_dest * slack + 1), rows_per_shard))

    def run(
        self,
        build: Table,
        probe: Table,
        group_capacity: Optional[int] = None,
        build_valid=None,
        probe_valid=None,
    ) -> GroupByResult:
        """``build_valid``/``probe_valid``: optional per-row validity (a
        pushed-down FILTER, query.py R2/R6).  Invalid rows are dropped at
        the exchange bucketizer — cold rows never travel and hot rows are
        excluded from ``is_hot_b`` — so groups aggregate valid rows only
        at zero extra passes."""
        for name, t in (("build", build), ("probe", probe)):
            if t.keys.dtype != jnp.int32 or t.payloads.dtype != jnp.int32:
                raise TypeError(
                    f"distributed join-aggregate is int32-only ({name} keys "
                    f"{t.keys.dtype}, payloads {t.payloads.dtype})"
                )
        s = self._num_shards
        if build.size % s or probe.size % s:
            raise ValueError("relation sizes must divide the shard count")
        use_hot = self._handle_skew
        if use_hot:
            hot_keys, hot_valid = plan_hot_keys(
                probe.keys,
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
        per_shard_rows = probe.size // s  # local hot rows join the pool
        for _ in range(self._max_retries):
            cap_a = self._capacity(build.size // s, slack)
            cap_b = self._capacity(probe.size // s, slack)
            (
                rk_a, _rp_a, rv_a, rk_b, rp_b, rv_b,
                is_hot_b, hk, _hp, hv, stats,
            ) = _exchange(
                self._mesh,
                build.keys,
                build.payloads,
                probe.keys,
                probe.payloads,
                self._shard_seed,
                hot_keys,
                hot_valid,
                self._hot_seed,
                cap_a,
                cap_b,
                hot_cap,
                use_hot,
                valid_a=build_valid,
                valid_b=probe_valid,
            )
            dropped = jax.device_get(
                (stats.dropped_a, stats.dropped_b, stats.dropped_hot)
            )
            if any(int(d) > 0 for d in dropped):
                self._logger.info(
                    "bucket overflow (a=%d b=%d hot=%d) at slack %.1f; "
                    "retrying",
                    int(dropped[0]), int(dropped[1]), int(dropped[2]), slack,
                )
                if int(dropped[0]) > 0 or int(dropped[1]) > 0:
                    slack *= 2
                if int(dropped[2]) > 0:
                    hot_cap = hot_cap * 4 + int(dropped[2])
                continue
            eff_valid = _effective_hot_valid(
                use_hot, hot_keys, hot_valid, hk, hv
            )
            g = self._aggregate_received(
                rk_a, rv_a, rk_b, rp_b, rv_b,
                probe, is_hot_b, hot_keys, eff_valid,
                use_hot, group_capacity,
                pool_rows=s * cap_b + per_shard_rows,
            )
            if g is not None:
                return g
        raise RuntimeError(
            f"join-aggregate capacities overflowed after "
            f"{self._max_retries} retries"
        )

    def _aggregate_received(
        self,
        rk_a, rv_a, rk_b, rp_b, rv_b,
        probe: Table,
        is_hot_b, hot_keys, eff_valid,
        use_hot: bool,
        group_capacity: Optional[int],
        pool_rows: int,
    ) -> Optional[GroupByResult]:
        """Inner retry loop over the aggregate capacities (the exchange
        results are reused across retries).  Returns None when the
        aggregate keeps overflowing (caller's outer loop gives up)."""
        s = self._num_shards
        hint = pool_rows if group_capacity is None else min(
            group_capacity, pool_rows
        )
        cap_local = max(16, hint)
        cap_merge_floor = 16
        slack = self._slack
        for _ in range(self._max_retries):
            cap_x = max(16, min(int(cap_local / s * slack + 1), cap_local))
            cap_merge = max(
                cap_merge_floor,
                min(int(cap_local * slack + 1), s * cap_x),
            )
            mk, mc, ms, mmn, mmx, m_nums, l_need, dropped, m_need = (
                _join_aggregate_local(
                    self._mesh,
                    rk_a, rv_a, rk_b, rp_b, rv_b,
                    probe.keys, probe.payloads, is_hot_b,
                    hot_keys, eff_valid, self._agg_seed,
                    use_hot, cap_local, cap_x, cap_merge,
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
                    group_of_row=jnp.full((probe.size,), -1, jnp.int32),
                )
            self._logger.info(
                "aggregate overflow (local need=%d/%d, dropped=%d, merge "
                "need=%d/%d) at slack %.1f; retrying",
                l_need, cap_local, dropped, m_need, cap_merge, slack,
            )
            if l_need > cap_local:
                cap_local = min(pool_rows, max(l_need, cap_local * 2))
            if m_need > cap_merge:
                cap_merge_floor = max(m_need, cap_merge * 2)
            if dropped:
                slack *= 2
        return None
